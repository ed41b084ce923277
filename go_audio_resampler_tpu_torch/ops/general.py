"""Per-tile banded resampling at data-dependent starts (K3): the CUDA
kernel and its plain version.

Counterpart of the JAX package's ``ops/pallas_fused.py`` for its kernel
``general_resample_pallas``, the core of the general (non-exact-rational)
and cubic one-shot paths:

    y[s, t*tile + p] = sum_{w < w_band} x[s, starts[t] + w] * m_t[t, w, p]

The matrices are laid out [n_tiles, w, tile], so the kernel reads each
tile's rows contiguously; they need no padding.  ``general_resample``
launches the hand-written kernel in ``csrc/general_resample.cu`` (built at
first use, see ``_build``) for CUDA tensors, and computes the plain
version for CPU tensors.  There is no fallback: a CUDA tensor the kernel
does not take raises.

The kernel reads each matrix only within its band: :func:`band_table`
gives, for each tile and each block of ``BAND_N`` output columns, the
k-steps (``K_STEP`` taps each) that hold the block's non-zeros.  The
table depends on M alone and is built once with it, on the host, where
the one-shot path uploads M; a CUDA call takes it as ``bands=`` and the
plain version ignores it.

Both take the product's precision tier (``ops/precision.py``; the JAX
kernel reads the process-wide one): the plain version forms its products
with ``precision.tiered_matmul``, the kernel splits M and the window into
limbs of the tier on chip, so M is prepared the same way at every tier.

The TPU module's ``choose_general_tile`` and ``general_vmem_bytes`` only
size TPU tiles to its scoped VMEM and have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.spans import K3, span
from . import _build
from .frames import gather_windows_at
from .precision import TIER_CODES, check_tier, tiered_matmul

#: Kernel launches so far (a plain integer; callers may reset it to 0).
launches = 0

_SOURCE = "general_resample"
#: taps per k-step of the kernel's tensor-core product (wgmma k8)
K_STEP = 8
#: output columns of one band entry
BAND_N = 8
#: output columns per warpgroup (the m64 of the kernel's wgmma)
WARPGROUP_P = 64
#: streams per block (the N of the kernel's wgmma)
TILE_S = 64
#: a one-warpgroup block where the 64-column groups of a 128-column pair
#: walk under this share of their union's k-steps (:func:`block_warpgroups`)
NARROW_SHARE = 0.65


def general_resample_reference(x: torch.Tensor, m_t: torch.Tensor,
                               starts: torch.Tensor, *, w_band: int,
                               tile: int,
                               tier: str) -> torch.Tensor:
    """Plain version: the clipped gather of each tile's window, then one
    ``einsum`` (the JAX package's lowering of ``_banded_tiles_apply``) at
    ``tier`` (``precision.tiered_matmul``).

    A window sample outside ``x`` reads its nearest end, as the kernel
    clamps it.  Computes in ``x``'s dtype; on a CUDA tensor a float32
    ``einsum`` follows ``torch.backends.cuda.matmul.allow_tf32``, which
    callers that use this as the oracle on the card set to False.
    """
    s, n = x.shape
    n_tiles = m_t.shape[0]
    if n_tiles == 0 or n == 0:
        return x.new_zeros((s, n_tiles * tile))
    frames = gather_windows_at(x, starts, w_band)        # [S, n_tiles, W]
    y = tiered_matmul(frames, m_t[:, :w_band, :].to(x.dtype), tier,
                      lambda a, b: torch.einsum('stw,twp->stp', a, b))
    return y.reshape(s, n_tiles * tile)


def band_table(m_t: torch.Tensor) -> torch.Tensor:
    """[n_tiles, ceil(tile/BAND_N), 2] int32 on the host: for each tile of
    ``m_t`` [n_tiles, w, tile] and each block of BAND_N output columns,
    the k-steps ``[lo, hi)`` (units of K_STEP taps counted from w = 0)
    that cover all its non-zero taps; ``[0, 0)`` where the block is all
    zero."""
    n_tiles, rows, tile = m_t.shape
    n_blocks = -(-tile // BAND_N)
    nz = (m_t != 0).cpu()
    if tile % BAND_N:
        nz = torch.cat([nz, nz.new_zeros((n_tiles, rows,
                                          n_blocks * BAND_N - tile))], dim=2)
    nz = nz.view(n_tiles, rows, n_blocks, BAND_N).any(dim=3)
    if rows == 0:
        return torch.zeros((n_tiles, n_blocks, 2), dtype=torch.int32)
    first = nz.to(torch.uint8).argmax(dim=1)   # [n_tiles, blocks]
    last = rows - 1 - nz.flip(1).to(torch.uint8).argmax(dim=1)
    table = torch.stack([first // K_STEP, last // K_STEP + 1], dim=2)
    return torch.where(nz.any(dim=1)[..., None], table, 0).int()


def own_share(bands: torch.Tensor) -> float:
    """Of the k-steps that the 128-column pairs of M's tiles walk (each
    pair's two groups of WARPGROUP_P columns over the union of their
    bands), the share that each group's own band holds (host work)."""
    b = bands.cpu().to(torch.int64)
    n_tiles, n_blocks, _ = b.shape
    per = WARPGROUP_P // BAND_N
    pairs = -(-n_blocks // (2 * per))
    g = torch.zeros((n_tiles, pairs * 2 * per, 2), dtype=torch.int64)
    g[:, :n_blocks] = b
    live = g[..., 1] > g[..., 0]
    lo = torch.where(live, g[..., 0], 1 << 30)
    hi = torch.where(live, g[..., 1], 0)

    def walk(width):
        lo_w = lo.view(n_tiles, -1, width).min(dim=2).values
        hi_w = hi.view(n_tiles, -1, width).max(dim=2).values
        return int(torch.where(hi_w > 0, hi_w - lo_w, 0).sum()) * width

    shared = walk(2 * per)
    return walk(per) / shared if shared else 1.0


def block_warpgroups(bands: torch.Tensor) -> int:
    """The kernel's block width for M with this band table, in warpgroups
    of WARPGROUP_P columns (host work, once with M).

    Each warpgroup walks the union of its columns' bands; a block walks
    the union of its warpgroups', sharing each stage of the window.  Where
    neighbouring groups' bands drift apart (:func:`own_share` under
    NARROW_SHARE: narrow diagonal bands, as in the cubic walk), a
    two-warpgroup block would idle each warpgroup over much of its
    stages: one warpgroup a block (2 k-steps a stage) then.  Else two
    share the window (4 k-steps a stage).
    """
    return 1 if own_share(bands) < NARROW_SHARE else 2


def check_bands(bands: torch.Tensor | None,
                m_t: torch.Tensor) -> torch.Tensor:
    """``bands`` checked against ``m_t`` and its device.  A kernel call
    takes the band table built once with M (:func:`band_table`), never per
    launch: None raises."""
    if bands is None:
        raise ValueError("general_resample: a CUDA call takes "
                         "bands=general.band_table(m_t), built once with M")
    n_tiles, _, tile = m_t.shape
    want = (n_tiles, -(-tile // BAND_N), 2)
    if (tuple(bands.shape) != want or bands.dtype != torch.int32
            or bands.device != m_t.device or not bands.is_contiguous()):
        raise ValueError(f"general_resample: bands must be a contiguous "
                         f"int32 {want} table on {m_t.device}, got "
                         f"{bands.dtype} {tuple(bands.shape)} on "
                         f"{bands.device}")
    return bands


def _check(x, m_t, starts, w_band, tile):
    if x.dim() != 2 or m_t.dim() != 3 or starts.dim() != 1:
        raise ValueError(
            "general_resample: x [S, n], m_t [n_tiles, w, tile] and starts "
            f"[n_tiles] expected, got {tuple(x.shape)}, {tuple(m_t.shape)} "
            f"and {tuple(starts.shape)}")
    n_tiles, rows, cols = m_t.shape
    if cols != tile or rows < w_band or w_band <= 0:
        raise ValueError(f"general_resample: m_t is {tuple(m_t.shape)}, "
                         f"expected (n_tiles, >= w_band={w_band}, "
                         f"tile={tile})")
    if starts.shape[0] != n_tiles:
        raise ValueError(f"general_resample: {starts.shape[0]} starts for "
                         f"{n_tiles} tiles")
    if starts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"general_resample: starts must be int32 or int64, "
                        f"got {starts.dtype}")


def general_resample(x: torch.Tensor, m_t: torch.Tensor,
                     starts: torch.Tensor, *, w_band: int, tile: int,
                     bands: torch.Tensor | None = None,
                     warpgroups: int = 2,
                     tier: str) -> torch.Tensor:
    """y [S, n_tiles*tile] with y[s, t*tile + p] =
    sum_{w < w_band} x[s, starts[t] + w] * m_t[t, w, p], at the matmul
    tier ``tier``, resolved (``precision.check_tier``).

    CUDA tensors go to the kernel, which takes contiguous float32 ``x`` and
    ``m_t``, contiguous int32 or int64 ``starts`` and M's band table
    ``bands`` (:func:`band_table`, on the same device), in blocks of
    ``warpgroups`` (1 or 2; :func:`block_warpgroups` chooses it with M),
    and raises on anything else; CPU tensors get
    :func:`general_resample_reference`, which ignores both.
    """
    global launches
    _check(x, m_t, starts, w_band, tile)
    check_tier(tier)
    with span(K3):
        devices = {x.device, m_t.device, starts.device}
        if devices == {torch.device("cpu")}:
            return general_resample_reference(x, m_t, starts, w_band=w_band,
                                              tile=tile, tier=tier)
        if len(devices) != 1 or x.device.type != "cuda":
            raise ValueError(f"general_resample: x on {x.device}, m_t on "
                             f"{m_t.device}, starts on {starts.device}; all "
                             "must be on one CUDA device (or all on the CPU)")
        if x.dtype != torch.float32 or m_t.dtype != torch.float32:
            raise TypeError(f"general_resample: the CUDA kernel takes "
                            f"float32, got x {x.dtype} and m_t {m_t.dtype}")
        if not (x.is_contiguous() and m_t.is_contiguous()
                and starts.is_contiguous()):
            raise ValueError(
                "general_resample: x, m_t and starts must be contiguous")
        bands = check_bands(bands, m_t)
        if warpgroups not in (1, 2):
            raise ValueError(f"general_resample: warpgroups must be 1 or 2, "
                             f"got {warpgroups}")
        s, n = x.shape
        n_tiles = m_t.shape[0]
        y = torch.empty((s, n_tiles * tile), dtype=torch.float32,
                        device=x.device)
        if y.numel() == 0:
            return y
        if n == 0:
            return y.zero_()
        fn = _launcher()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(x.data_ptr(), x.stride(0), n, starts.data_ptr(),
                     int(starts.dtype == torch.int64), m_t.data_ptr(),
                     m_t.shape[1], bands.data_ptr(), y.data_ptr(), n_tiles, s,
                     w_band, tile, warpgroups, TIER_CODES[tier], stream)
        if err:
            raise RuntimeError(
                f"general_resample: kernel launch failed with CUDA error "
                f"{err} (S={s}, n={n}, n_tiles={n_tiles}, w_band={w_band}, "
                f"tile={tile}, tier={tier})")
        launches += 1
        return y


@functools.cache
def _launcher():
    """The kernel's C launcher with its ctypes signature (built once)."""
    fn = _build.load(_SOURCE).general_resample_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn
