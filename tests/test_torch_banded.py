"""The banded operator as K1 and K2 read it (``ops/banded.py``), and the
3xTF32 arithmetic of their tile product, on the CPU.

The CUDA kernels run only on the card (``test_torch_cuda.py``).  Here:
the band table covers every non-zero of R on the k-step grid; R's TF32
limbs are exact and packed where the kernels read them; the build keys a
library on the headers its source includes; and a numpy emulation of the
kernels' arithmetic (limbs, bands, stages, cluster split), run through
the port's float32 ``EngineCore``, stays within 2e-5 of the JAX package's
float64 ``EngineCore`` on the same inputs.
"""

import re
import shutil

import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.engine.streaming import EngineCore as JEngine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu_torch.engine import EngineCore, plan_from_arrays
from go_audio_resampler_tpu_torch.ops import _build, banded, fused
from go_audio_resampler_tpu_torch.ops.frames import gather_windows

TOL = 2e-5
#: (name, rates, quality, engine block): the main path's operator, the
#: decimation path's, 48k -> 44.1k, and a superframed VERY_HIGH one.
OPERATORS = {
    "main": ((44100, 48000), 3, 2352),
    "decimation": ((48000, 16000), 3, 2048),
    "48k->44.1k": ((48000, 44100), 3, 2352),
    "superframed VERY_HIGH": ((44100, 48000), 4, 2048),
}
#: k-steps per stage of the kernels' ring (kKS in csrc/banded_mma.cuh)
STAGE_KSTEPS = 2


def _plans(rates, q):
    jp = jplan_engine(rates[0], rates[1], JQuality(q))
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


def _r_t(name) -> torch.Tensor:
    """R_t [wx, p2] float32 of an operator, as the engine builds it."""
    rates, q, block = OPERATORS[name]
    eng = EngineCore(_plans(rates, q)[1], block=block, device="cpu")
    return eng._band.r_t.float()


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().astype(np.int64) & 0x1FFF


# -- band table -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(OPERATORS))
def test_band_table_covers_every_nonzero_on_the_kstep_grid(name):
    r_t = _r_t(name)
    wx, p2 = r_t.shape
    bands = banded.band_table(r_t).numpy()
    assert bands.shape == (-(-p2 // banded.BAND_N), 2)
    assert bands.dtype == np.int32
    nz = (r_t != 0).numpy()
    for nb, (lo, hi) in enumerate(bands):
        taps = np.nonzero(nz[:, nb * 8:(nb + 1) * 8].any(axis=1))[0]
        assert taps.size, f"column block {nb} is all zero"
        # every non-zero tap lies in [8*lo, 8*hi), and the range is the
        # tightest one on the grid of k-steps counted from w = 0
        assert lo * banded.K_STEP <= taps[0] < (lo + 1) * banded.K_STEP
        assert (hi - 1) * banded.K_STEP <= taps[-1] < hi * banded.K_STEP
        assert hi <= -(-wx // banded.K_STEP)
    tiles = banded.tile_bands(torch.from_numpy(bands)).numpy()
    per = banded.TILE_N // banded.BAND_N
    for j, (lo, hi) in enumerate(tiles):
        blk = bands[j * per:(j + 1) * per]
        assert (lo, hi) == (blk[:, 0].min(), blk[:, 1].max())


def test_band_table_of_an_all_zero_block_is_empty():
    r_t = torch.zeros((40, 24))
    r_t[3, 0] = 1.0
    r_t[17, 20] = -2.0
    assert banded.band_table(r_t).tolist() == [[0, 1], [0, 0], [2, 3]]
    assert banded.tile_bands(banded.band_table(r_t)).tolist() == [[0, 3]]


def test_split_fills_the_card_at_the_decimation_shape():
    """The decimation operator's long bands are split across clusters of
    8, so its 256-stream step launches more blocks than the card has SMs;
    the main operator's bands are short enough for one tall block each."""
    dec = banded.prepare(_r_t("decimation"), tier="highest")
    main = banded.prepare(_r_t("main"), tier="highest")
    assert (dec.split, main.split) == (8, 1)
    assert (banded.tile_rows(8), banded.tile_rows(1)) == (128, 256)
    rows = 256 * 2                                    # streams x frames
    blocks = (-(-rows // banded.tile_rows(dec.split))) \
        * (-(-512 // banded.TILE_N)) * dec.split
    assert blocks >= 132
    tiles = banded.tile_bands(dec.bands)
    widest = int((tiles[:, 1] - tiles[:, 0]).max())
    assert -(-widest // dec.split) <= banded.SPLIT_KSTEPS


# -- limbs ----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(OPERATORS))
def test_limbs_are_tf32_and_reconstruct_r(name):
    r_t = _r_t(name)
    hi, lo = banded.split_limbs(r_t)
    assert not _bits(hi).any() and not _bits(lo).any()     # TF32 values
    r64 = r_t.double()
    # hi is R rounded to nearest TF32: within half its unit in the last
    # place (2**-11 relative); hi + lo is R to within 2**-22 of |R|.
    assert ((hi.double() - r64).abs() <= 2.0 ** -11 * r64.abs()).all()
    err = (hi.double() + lo.double() - r64).abs()
    assert (err <= 2.0 ** -22 * r64.abs()).all()


def test_tf32_round_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0 + 3 * 2.0 ** -11,
                      0.0, -0.0, 3.0e38], dtype=torch.float32)
    got = banded.tf32_round(x).tolist()
    assert got[:4] == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                       1.0 + 4 * 2.0 ** -11]
    assert got[4:6] == [0.0, 0.0] and got[6] == pytest.approx(3.0e38, 1e-3)
    with pytest.raises(TypeError, match="float32"):
        banded.tf32_round(x.double())


@pytest.mark.parametrize("name", ["main", "decimation"])
def test_packed_limbs_are_where_the_kernels_read_them(name):
    r_t = _r_t(name)
    wx, p2 = r_t.shape
    op = banded.prepare(r_t, tier="highest")
    hi, lo = banded.split_limbs(r_t)
    ks, nb = -(-wx // 8), -(-p2 // 8)
    assert tuple(op.packed.shape) == (nb, ks, 32, 4)
    assert (op.wx, op.p2) == (wx, p2)
    # chunk c = 16*limb + 8*half + col holds taps 8*ks + 4*half + 0..3 of
    # column 8*nb + col
    v = op.packed.view(nb, ks, 2, 2, 8, 4).permute(2, 1, 3, 5, 0, 4)
    limbs = v.reshape(2, ks * 8, nb * 8)
    assert torch.equal(limbs[0, :wx, :p2], hi)
    assert torch.equal(limbs[1, :wx, :p2], lo)
    assert not limbs[:, wx:].any() and not limbs[:, :, p2:].any()


def test_prepare_checks_and_resolve():
    r_t = _r_t("main")
    op = banded.prepare(r_t, tier="highest")
    assert banded.resolve(op, r_t, "k", tier="highest") is op
    with pytest.raises(ValueError, match="op=banded.prepare"):
        # never prepared per launch
        banded.resolve(None, r_t, "k", tier="highest")
    with pytest.raises(ValueError, match="prepared for"):
        banded.resolve(op, r_t[:, :100], "k", tier="highest")
    with pytest.raises(TypeError, match="float32"):
        banded.prepare(r_t.double(), tier="highest")
    with pytest.raises(ValueError, match="wx, p2"):
        banded.prepare(r_t[None], tier="highest")
    # a CPU tensor
    assert banded.prepare_on_card(r_t, tier="highest") is None


# -- the build ------------------------------------------------------------------

def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.sources("fused_resample")] == [
        "fused_resample.cu", "banded_mma.cuh"]
    assert [p.name for p in _build.sources("general_resample")] == [
        "general_resample.cu", "banded_mma.cuh"]
    k1, k2, k3 = (_build.library_path(n) for n in (
        "fused_resample", "fused_resample_tmajor", "general_resample"))
    source = csrc / "general_resample.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build.library_path("general_resample") != k3
    assert _build.library_path("fused_resample") == k1
    k3 = _build.library_path("general_resample")
    header = csrc / "banded_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("fused_resample") != k1
    assert _build.library_path("fused_resample_tmajor") != k2
    assert _build.library_path("general_resample") != k3
    k3 = _build.library_path("general_resample")
    (csrc / "unrelated.cuh").write_text("// not included\n")
    assert _build.library_path("general_resample") == k3


def test_python_tile_constants_match_the_kernels():
    text = (_build.CSRC / "banded_mma.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kBN") == banded.TILE_N
    assert 64 * const("kTallWarpgroups") == banded.tile_rows(1)
    assert 64 * const("kShortWarpgroups") == banded.tile_rows(2)
    assert const("kKS") == STAGE_KSTEPS
    assert const("kMaxSplit") == banded.MAX_SPLIT
    assert f"m64n{banded.TILE_N}k8.f32.tf32.tf32" in text


# -- 3xTF32 arithmetic ------------------------------------------------------------

def _tf32_rna(a: np.ndarray) -> np.ndarray:
    b = a.view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def emulate_kernel(data, r_t, *, ipx, wx, p2, n_frames, op=None,
                   tier="highest", head=None, width=None):
    """The kernels' arithmetic at the 'highest' tier in numpy, float32 in
    and out, over K1's virtual rows ``head ++ data ++ zeros``
    (``fused.virtual_row``): signal limbs (hi rounded to TF32, lo the remainder as the
    tensor cores read it), R's prepared limbs with B zero outside each n8 block's band, per
    column tile the union band cut into ``split`` parts, and per part
    stages of STAGE_KSTEPS k-steps, each starting from zero, of three
    passes (lo*hi, hi*lo, hi*hi), each pass an 8-tap product added to the
    stage's float32 sum; stages summed in float32, parts in rank order."""
    del op
    assert tier == 'highest', tier
    s = data.shape[0]
    r32 = r_t.float()
    op = banded.prepare(r32, 'highest')
    data = fused.virtual_row(data, head, width)
    frames = gather_windows(data.float(), n_frames, ipx, wx).numpy()
    m = s * n_frames
    ks_total, nb_total = -(-wx // 8), -(-p2 // 8)
    a = np.zeros((m, ks_total * 8), np.float32)
    a[:, :wx] = frames.reshape(m, wx)
    a_hi = _tf32_rna(a)
    a_lo = _tf32_trunc(a - a_hi)
    hi, lo = (t.numpy() for t in banded.split_limbs(r32))
    b_hi = np.zeros((ks_total * 8, nb_total * 8), np.float32)
    b_lo = np.zeros_like(b_hi)
    for nb, (k0, k1) in enumerate(op.bands.numpy()):
        rows, cols = slice(8 * k0, min(8 * k1, wx)), slice(8 * nb,
                                                           min(8 * nb + 8, p2))
        b_hi[rows, cols] = hi[rows, cols]
        b_lo[rows, cols] = lo[rows, cols]
    y = np.zeros((m, nb_total * 8), np.float32)
    for j, (k0, k1) in enumerate(banded.tile_bands(op.bands).numpy()):
        cols = slice(j * banded.TILE_N, (j + 1) * banded.TILE_N)
        parts = []
        for q in range(op.split):
            b = k0 + (k1 - k0) * q // op.split
            e = k0 + (k1 - k0) * (q + 1) // op.split
            acc = np.zeros((m, y[:, cols].shape[1]), np.float32)
            for st in range(b, e, STAGE_KSTEPS):
                part = np.zeros_like(acc)
                for ks in range(st, min(st + STAGE_KSTEPS, e)):
                    k = slice(8 * ks, 8 * ks + 8)
                    for aa, bb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                        part = (part.astype(np.float64)
                                + aa[:, k].astype(np.float64)
                                @ bb[k, cols].astype(np.float64)
                                ).astype(np.float32)
                acc = acc + part
            parts.append(acc)
        v = parts[0]
        for p in parts[1:]:
            v = v + p
        y[:, cols] = v
    return torch.from_numpy(np.ascontiguousarray(y[:, :p2])).reshape(
        s, n_frames * p2)


@pytest.mark.parametrize("name,streams,n", [
    ("main", 4, 9 * 2352 + 1234),
    ("decimation", 2, 3 * 3072 + 777),
])
def test_3xtf32_emulation_matches_jax_float64_engine(monkeypatch, name,
                                                     streams, n):
    """The port's float32 engine, its step computed as the kernels compute
    it, against the JAX package's float64 engine on the same inputs."""
    rates, q, block = OPERATORS[name]
    jp, tp = _plans(rates, q)
    x = np.random.default_rng(31).normal(size=(streams, n)) * 0.5
    je = JEngine(jp, batch=streams, block=block, dtype=np.float64)
    want = np.concatenate([np.asarray(je.process(x)),
                           np.asarray(je.flush())], 1)
    calls = []

    def kernel(data, r_t, **kw):
        calls.append(kw["n_frames"])
        return emulate_kernel(data, r_t, **kw)

    monkeypatch.setattr(fused, "fused_resample", kernel)
    te = EngineCore(tp, batch=streams, block=block, dtype=torch.float32,
                    device="cpu")
    got = np.concatenate([te.process(x[:, :n // 3].astype(np.float32)),
                          te.process(x[:, n // 3:].astype(np.float32)),
                          te.flush()], 1)
    assert calls and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    # and on one step it agrees with the plain float32 version
    r_t = te._band.r_t
    xd = torch.from_numpy(x[:, :4000].astype(np.float32))
    kw = dict(ipx=te._band.ipx, wx=te._band.wx, p2=te._band.p2,
              n_frames=(4000 - te._band.wx) // te._band.ipx + 1,
              tier="highest")
    ref = fused.fused_resample_reference(xd, r_t, **kw)
    emu = emulate_kernel(xd, r_t, **kw)
    assert (emu - ref).abs().max().item() <= TOL
