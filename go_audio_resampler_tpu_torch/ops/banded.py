"""The banded operator as K1 and K2 read it: R's limbs at the product's
precision tier, in the order the tensor cores read them, and the band of
taps of each output tile.

K1 (``csrc/fused_resample.cu``) and K2 (``csrc/fused_resample_tmajor.cu``)
share one tile product (``csrc/banded_mma.cuh``) on the tensor cores
(``wgmma``, float32 accumulation), where ``a`` is the signal (split into
limbs in registers) and ``b`` is R, at one of three tiers
(``ops/precision.py``):

- ``'highest'``: TF32 limbs, per step of ``K_STEP`` taps
  ``acc += a_lo*b_hi;  acc += a_hi*b_lo;  acc += a_hi*b_hi``;
- ``'high'``: the same three products of bf16 limbs, per 16 taps;
- ``'default'``: one product of the bf16 ``hi`` limbs, per 16 taps.

:func:`prepare` forms R's limbs at the operator's tier once, when the
operator is built, packed in the order in which the tensor cores read B,
and computes for each block of 8 output columns (one n8 fragment) the
range of ``K_STEP``-tap k-steps that holds its non-zero taps: its band.
A bf16 product of 16 taps walks two such k-steps.
A block of ``TILE_N`` columns walks the union of its fragments' bands, and
each fragment takes part only in its own band's k-steps.  The kernels read
nothing else of R.

Everything here depends on the operator only (R, hence Wx and P2), never
on the signal's shape: an output's arithmetic, and so its bits, is the
same whatever the launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.spans import BANDED_PREPARE, span
from .precision import check_tier, split_bf16

#: taps per k-step of the bands (one TF32 wgmma k8; half a bf16 k16)
K_STEP = 8
#: output columns of one band entry (an n8 fragment)
BAND_N = 8
#: output columns per block
TILE_N = 80
#: k-steps a block walks before its tile's band is split across a
#: thread-block cluster
SPLIT_KSTEPS = 48
#: largest cluster of the tap split
MAX_SPLIT = 8


class BandedOperator(NamedTuple):
    """R prepared for K1 and K2 (see the module docstring).

    ``packed``, at ``tier`` ``'highest'``: [ceil(p2/8), ceil(wx/8), 32, 4]
    float32, for column block ``nb`` and k-step ``ks`` 32 rows of 4 taps,
    row ``16*limb + 8*half + col`` holding TF32 limb ``limb`` (hi, lo) of
    R_t at taps ``8*ks + 4*half + 0..3``, column ``8*nb + col``.  At
    ``'high'`` and ``'default'``: [ceil(p2/8), ceil(wx/8), 8*L, 8]
    bfloat16, L = 2 or 1 limbs, row ``8*limb + col`` holding bf16 limb
    ``limb`` at taps ``8*ks + 0..7``.  Either way 8 x 16-byte K-major
    core matrices, the layout in which the tensor cores read B from shared
    memory; zero beyond R.  ``bands`` [ceil(p2/8), 2] int32: each n8
    block's k-steps ``[lo, hi)``, empty for an all-zero block.
    ``split``: the blocks of a cluster that share one column tile's band.
    ``tier``: the tier the limbs were formed at; a kernel call at another
    tier refuses them.
    """
    packed: torch.Tensor
    bands: torch.Tensor
    split: int
    wx: int
    p2: int
    tier: str = 'highest'


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does; the low 13 bits of the
    result are zero."""
    if t.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_limbs(r_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): TF32 limbs of float32 ``r_t`` with hi + lo = r_t to
    within 2**-22 of |r_t|."""
    hi = tf32_round(r_t)
    return hi, tf32_round(r_t - hi)


def band_table(r_t: torch.Tensor) -> torch.Tensor:
    """[ceil(p2/BAND_N), 2] int32 on the host: for each block of BAND_N
    columns of R_t [wx, p2], the k-steps ``[lo, hi)`` (units of K_STEP
    taps counted from w = 0) that cover all its non-zero taps; ``[0, 0)``
    where the block is all zero."""
    wx, p2 = r_t.shape
    n_blocks = -(-p2 // BAND_N)
    nz = torch.zeros((wx, n_blocks * BAND_N), dtype=torch.bool)
    nz[:, :p2] = (r_t != 0).cpu()
    nz = nz.view(wx, n_blocks, BAND_N).any(dim=2).int()   # [wx, blocks]
    first = nz.argmax(dim=0)                   # first non-zero tap
    last = wx - 1 - nz.flip(0).argmax(dim=0)   # last non-zero tap
    table = torch.stack([first // K_STEP, last // K_STEP + 1], dim=1)
    return torch.where(nz.any(dim=0)[:, None], table, 0).int()


def tile_bands(bands: torch.Tensor) -> torch.Tensor:
    """[ceil(p2/TILE_N), 2]: the k-steps each block of TILE_N columns
    walks, the union of its n8 blocks' bands (``[0, 0)`` if all empty)."""
    per = TILE_N // BAND_N
    n_tiles = -(-bands.shape[0] // per)
    b = torch.zeros((n_tiles * per, 2), dtype=torch.int32)
    b[:bands.shape[0]] = bands.cpu()
    b = b.view(n_tiles, per, 2)
    live = b[..., 1] > b[..., 0]
    lo = torch.where(live, b[..., 0], torch.iinfo(torch.int32).max)
    hi = torch.where(live, b[..., 1], 0)
    out = torch.stack([lo.min(dim=1).values, hi.max(dim=1).values], dim=1)
    return torch.where(live.any(dim=1)[:, None], out, 0).int()


def choose_split(bands: torch.Tensor) -> int:
    """Blocks per cluster sharing a column tile's band: the least power of
    two that leaves each at most SPLIT_KSTEPS k-steps of the widest tile
    band (:func:`tile_bands`), capped at MAX_SPLIT."""
    tiles = tile_bands(bands)
    widest = int((tiles[:, 1] - tiles[:, 0]).max()) if tiles.numel() else 0
    split = 1
    while split < MAX_SPLIT and -(-widest // split) > SPLIT_KSTEPS:
        split *= 2
    return split


def pack_fragments(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The limbs [wx, p2] as the kernels stage them
    (``BandedOperator.packed``)."""
    wx, p2 = hi.shape
    ks, nb = -(-wx // K_STEP), -(-p2 // 8)
    limbs = hi.new_zeros((2, ks * K_STEP, nb * 8))
    limbs[0, :wx, :p2] = hi
    limbs[1, :wx, :p2] = lo
    # [limb, ks, half, tap, nb, col] -> [nb, ks, limb, half, col, tap]:
    # tap 8*ks + 4*half + tap of column 8*nb + col
    v = limbs.view(2, ks, 2, 4, nb, 8).permute(4, 1, 0, 2, 5, 3)
    return v.contiguous().view(nb, ks, 32, 4)


def pack_bf16(limbs: list[torch.Tensor]) -> torch.Tensor:
    """bf16-valued float32 limbs [wx, p2] (hi, or hi and lo) as the
    kernels stage them at a bf16 tier (``BandedOperator.packed``)."""
    n_limbs = len(limbs)
    wx, p2 = limbs[0].shape
    ks, nb = -(-wx // K_STEP), -(-p2 // 8)
    buf = limbs[0].new_zeros((n_limbs, ks * K_STEP, nb * 8))
    for i, limb in enumerate(limbs):
        buf[i, :wx, :p2] = limb
    # [limb, ks, tap, nb, col] -> [nb, ks, limb, col, tap]
    v = buf.view(n_limbs, ks, K_STEP, nb, 8).permute(3, 1, 0, 4, 2)
    return v.contiguous().view(nb, ks, 8 * n_limbs, 8).to(torch.bfloat16)


def tile_rows(split: int) -> int:
    """Signal rows per block for an operator of this split: 256 (four
    warpgroups, one block an SM) where one block walks a column tile's
    whole band, 128 (two warpgroups, two blocks an SM) where a cluster
    shares it."""
    return 256 if split == 1 else 128


def prepare(r_t: torch.Tensor, tier: str) -> BandedOperator:
    """R_t [wx, p2] float32 prepared for K1 and K2 at the resolved ``tier``
    (``precision.check_tier``), on ``r_t``'s device.

    Built once with the operator, at the tier its caller runs (the
    engines' ``Band``, the one-shot operators, the banded convolution);
    reads R_t back to the host once for its band table.
    """
    if r_t.dim() != 2:
        raise ValueError(f"prepare: R_t [wx, p2] expected, got "
                         f"{tuple(r_t.shape)}")
    if r_t.dtype != torch.float32:
        raise TypeError(f"prepare: the kernels take float32, got {r_t.dtype}")
    check_tier(tier)
    with span(BANDED_PREPARE):
        wx, p2 = r_t.shape
        if tier == 'highest':
            packed = pack_fragments(*split_limbs(r_t.contiguous()))
        else:
            hi, lo = split_bf16(r_t.contiguous())
            packed = pack_bf16([hi, lo] if tier == 'high' else [hi])
        bands = band_table(r_t)
        return BandedOperator(packed, bands.to(r_t.device),
                              choose_split(bands), wx, p2, tier)


def prepare_on_card(r_t: torch.Tensor, tier: str) -> BandedOperator | None:
    """``prepare(r_t, tier)`` where R_t lies on the card (the kernels'
    operand), None elsewhere (the plain versions read R_t itself)."""
    return prepare(r_t, tier) if r_t.device.type == "cuda" else None


def resolve(op: BandedOperator | None, r_t: torch.Tensor, who: str,
            tier: str) -> BandedOperator:
    """``op`` checked against R_t [wx, p2], its device and the call's
    ``tier``.  A kernel call takes R prepared with its operator, never per
    launch: None raises, and so do limbs of another tier."""
    if op is None:
        raise ValueError(f"{who}: a CUDA call takes op=banded.prepare(r_t, "
                         "tier), prepared once with the operator")
    if ((op.wx, op.p2) != tuple(r_t.shape) or op.packed.device != r_t.device
            or op.bands.device != r_t.device):
        raise ValueError(f"{who}: op was prepared for R_t ({op.wx}, {op.p2}) "
                         f"on {op.packed.device}, got R_t "
                         f"{tuple(r_t.shape)} on {r_t.device}")
    if op.tier != tier:
        raise ValueError(f"{who}: op was prepared at tier {op.tier!r}, the "
                         f"call runs at {tier!r}; prepare it with "
                         "banded.prepare(r_t, tier)")
    return op
