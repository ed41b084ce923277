"""K3's band table and its 3xTF32 arithmetic, on the CPU.

The CUDA kernel (``ops/csrc/general_resample.cu``) runs only on the card
(``test_torch_cuda.py``).  Here: ``general.band_table`` covers every
non-zero of the one-shot tile matrices and nothing outside its k-steps is
non-zero (against a brute-force scan); ``_oneshot_aux`` carries the table
beside M; a CUDA call without it raises; the kernel's constants match
the wrapper's; and a numpy emulation of the kernel's arithmetic (limbs
split as the kernel splits them, each warpgroup's k-steps in stages that
start from zero), run through the port's float32 ``oneshot``, stays
within 2e-5 of the JAX package's float64 ``oneshot`` on the same inputs.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
import go_audio_resampler_tpu_torch as gart
from go_audio_resampler_tpu_torch.engine import plan_from_arrays
from go_audio_resampler_tpu_torch.ops import _build, banded, general
from go_audio_resampler_tpu_torch.ops.frames import gather_windows_at

joneshot = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")

TOL = 2e-5
#: The one-shot topologies that run K3, by name: rates, quality, options.
K3_TOPOLOGIES = {
    "general": (44100, 48001, 3, {}),
    "general_hq": (44100, 48001, 3, {"hq_interp": True}),
    "cubic": (44100, 48000, 0, {}),
}
#: k-steps per stage of the kernel's blocks of one and of two warpgroups
#: (kStageKsteps1, kStageKsteps2 in general_resample.cu)
STAGE_KSTEPS = {1: 2, 2: 4}


def _plans(name):
    r_in, r_out, q, kw = K3_TOPOLOGIES[name]
    jp = jplan_engine(r_in, r_out, JQuality(q), **kw)
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


def _tile_matrices(name, count) -> torch.Tensor:
    """M [n_tiles, w, tile] float32 of a K3 topology, as ``_upload``
    lays it out."""
    _, tp = _plans(name)
    build = (toneshot._cubic_matrices if tp.kind == "cubic"
             else toneshot._general_matrices)
    _, m = build(tp, count)
    return torch.from_numpy(np.ascontiguousarray(
        m.transpose(0, 2, 1), dtype=np.float32))


def _brute_force_bands(m: np.ndarray) -> np.ndarray:
    n_tiles, rows, tile = m.shape
    out = np.zeros((n_tiles, -(-tile // 8), 2), np.int32)
    for t in range(n_tiles):
        for nb in range(out.shape[1]):
            taps = np.nonzero((m[t, :, nb * 8:(nb + 1) * 8] != 0).any(1))[0]
            if taps.size:
                out[t, nb] = (taps[0] // 8, taps[-1] // 8 + 1)
    return out


def _check_table(m: torch.Tensor) -> np.ndarray:
    bands = general.band_table(m)
    assert bands.dtype == torch.int32 and bands.device.type == "cpu"
    b, mm = bands.numpy(), m.numpy()
    assert np.array_equal(b, _brute_force_bands(mm))
    # every non-zero lies in its block's k-steps, and nothing outside them
    # is non-zero
    rows = np.arange(mm.shape[1])[None, :, None]
    cols = np.arange(mm.shape[2]) // 8
    lo = b[:, cols, 0][:, None, :] * 8
    hi = b[:, cols, 1][:, None, :] * 8
    outside = (rows < lo) | (rows >= hi)
    assert not np.any(mm[np.broadcast_to(outside, mm.shape)])
    return b


# -- band table -----------------------------------------------------------------

@pytest.mark.parametrize("name,count", [
    ("general", 700), ("general", 4460), ("general_hq", 1500),
    ("general_hq", 2900), ("cubic", 999), ("cubic", 3266),
])
def test_band_table_covers_every_nonzero_of_the_one_shot_matrices(name,
                                                                   count):
    m = _tile_matrices(name, count)
    b = _check_table(m)
    assert b.shape == (m.shape[0], m.shape[2] // 8, 2)
    # the bands are a small share of the dense matrix
    walked = (b[..., 1] - b[..., 0]).sum() * 64
    assert 0 < walked < m.numel()


@pytest.mark.parametrize("shape,density", [
    ((3, 40, 24), 1.0), ((2, 33, 20), 0.05), ((4, 17, 7), 0.2),
    ((2, 16, 256), 0.0), ((1, 9, 3), 1.0),
])
def test_band_table_of_random_and_all_zero_tiles(shape, density):
    rng = np.random.default_rng(sum(shape))
    m = rng.normal(size=shape) * (rng.random(shape) < density)
    b = _check_table(torch.from_numpy(m.astype(np.float32)))
    if density == 0.0:
        assert not b.any()                      # [0, 0) everywhere
    if density == 1.0:
        assert (b[..., 0] == 0).all() and (b[..., 1] == -(-shape[1] // 8)).all()


def test_band_table_of_hand_made_tiles():
    m = torch.zeros((2, 40, 24))
    m[0, 3, 0] = 1.0
    m[0, 17, 20] = -2.0
    m[1, 39, 9] = 0.5
    m[1, 8, 15] = 0.25
    assert general.band_table(m).tolist() == [
        [[0, 1], [0, 0], [2, 3]], [[0, 0], [1, 5], [0, 0]]]


# -- the one-shot operator and the wrapper ----------------------------------------

@pytest.mark.parametrize("name", list(K3_TOPOLOGIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_oneshot_aux_carries_the_band_table(name, dtype):
    _, tp = _plans(name)
    aux = toneshot._oneshot_aux(tp, 2000, dtype, "cpu", tier="highest")
    assert len(aux) == 4
    starts, m, bands, warpgroups = aux
    assert starts.dtype == torch.int64 and m.dtype == dtype
    assert bands.dtype == torch.int32 and bands.device.type == "cpu"
    assert torch.equal(bands, general.band_table(m))
    assert general.check_bands(bands, m) is bands
    assert warpgroups == general.block_warpgroups(bands)


@pytest.mark.parametrize("name,count,warpgroups", [
    ("general", 700, 2), ("general", 4460, 2), ("general_hq", 2900, 2),
    ("cubic", 999, 1), ("cubic", 3266, 1),
])
def test_block_width_follows_the_bands(name, count, warpgroups):
    """Wide bands (the general walk) share each stage of the window over
    two warpgroups; narrow diagonal ones (the cubic walk) take one."""
    bands = general.band_table(_tile_matrices(name, count))
    share = general.own_share(bands)
    assert 0 < share <= 1
    assert (share < general.NARROW_SHARE) == (warpgroups == 1)
    assert general.block_warpgroups(bands) == warpgroups
    wide = torch.ones((2, 40, 256))            # every block walks all
    assert general.block_warpgroups(general.band_table(wide)) == 2
    narrow = torch.zeros((2, 300, 256))        # 64-column groups apart
    for q in range(4):
        narrow[:, 70 * q:70 * q + 8, 64 * q:64 * q + 64] = 1.0
    assert general.block_warpgroups(general.band_table(narrow)) == 1


def test_a_cuda_call_takes_the_band_table():
    m = _tile_matrices("cubic", 999)
    bands = general.band_table(m)
    with pytest.raises(ValueError, match="bands=general.band_table"):
        general.check_bands(None, m)           # never built per launch
    with pytest.raises(ValueError, match="int32"):
        general.check_bands(bands.long(), m)
    with pytest.raises(ValueError, match="int32"):
        general.check_bands(bands[:-1].contiguous(), m)
    with pytest.raises(ValueError, match="int32"):
        general.check_bands(bands[:, ::2], m[:, :, :128])


def test_the_plain_version_ignores_the_band_table():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3, 400)))
    m = torch.from_numpy(rng.normal(size=(4, 30, 16)))
    starts = torch.tensor([-2, 50, 120, 380])
    want = general.general_resample(x, m, starts, w_band=30, tile=16,
                                    tier="highest")
    before = general.launches
    got = general.general_resample(x, m, starts, w_band=30, tile=16,
                                   bands=general.band_table(m), tier="highest")
    assert torch.equal(got, want) and general.launches == before


def test_python_tile_constants_match_the_kernel():
    text = (_build.CSRC / "general_resample.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             text)[1].split()[-1])

    assert const("kBS") == general.TILE_S
    assert const("kStageKsteps1") == STAGE_KSTEPS[1]
    assert const("kStageKsteps2") == STAGE_KSTEPS[2]
    assert "kBP = 64 * WG" in text and general.WARPGROUP_P == 64
    assert f"m64n{general.TILE_S}k{general.K_STEP}.f32.tf32.tf32" in text
    assert [p.name for p in _build.sources("general_resample")] == [
        "general_resample.cu", "banded_mma.cuh"]


# -- 3xTF32 arithmetic -------------------------------------------------------------

def _tf32_trunc(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _limbs(a: np.ndarray):
    """(hi, lo) as the kernel forms them on chip: hi rounded to TF32 as
    ``banded.tf32_round`` does, lo the remainder as the tensor cores read
    it (its top 19 bits)."""
    hi = banded.tf32_round(torch.from_numpy(a)).numpy()
    return hi, _tf32_trunc(a - hi)


def emulate_k3(x, m_t, starts, *, w_band, tile, bands=None, warpgroups=2,
               tier="highest"):
    """K3's arithmetic at the 'highest' tier in numpy, float32 in and
    out: M's limbs (the A operand) and the window's (B), each warpgroup's
    64 columns walking the union of their 8-column bands (clipped to
    w_band), in stages of
    STAGE_KSTEPS[warpgroups] k-steps on the grid from tap 0; a stage's sum
    starts from zero and takes, per k-step, three passes (lo*hi, hi*lo,
    hi*hi), each an 8-tap product added to it in float32; stages summed in
    float32."""
    assert tier == 'highest', tier
    ksteps = STAGE_KSTEPS[warpgroups]
    wp = general.WARPGROUP_P
    n_tiles = m_t.shape[0]
    s = x.shape[0]
    m32 = m_t.float()
    b = (general.band_table(m32) if bands is None else bands).numpy()
    ks_total = -(-w_band // 8)
    groups = -(-tile // wp)
    cols = groups * wp
    xw = np.zeros((n_tiles, s, ks_total * 8), np.float32)
    xw[:, :, :w_band] = gather_windows_at(
        x.float(), starts, w_band).numpy().transpose(1, 0, 2)
    mw = np.zeros((n_tiles, ks_total * 8, cols), np.float32)
    mw[:, :w_band, :tile] = m32[:, :w_band].numpy()
    a_hi, a_lo = _limbs(mw)
    b_hi, b_lo = _limbs(xw)
    # each warpgroup's k-steps: the union of its 8-column blocks' bands
    per = wp // 8
    bb = np.zeros((n_tiles, groups * per, 2), np.int64)
    bb[:, :b.shape[1]] = b
    bb[..., 1] = np.minimum(bb[..., 1], ks_total)
    live = bb[..., 1] > bb[..., 0]
    bb = bb.reshape(n_tiles, groups, per, 2)
    live = live.reshape(n_tiles, groups, per)
    wlo = np.where(live, bb[..., 0], 1 << 30).min(axis=2)
    whi = np.where(live, bb[..., 1], 0).max(axis=2)
    acc = np.zeros((n_tiles, s, groups, wp), np.float32)
    for st in range(-(-ks_total // ksteps)):
        part = np.zeros_like(acc)
        for ks in range(st * ksteps, min((st + 1) * ksteps, ks_total)):
            inside = ((wlo <= ks) & (ks < whi))[:, None, :, None]
            k = slice(8 * ks, 8 * ks + 8)
            for aa, bx in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                prod = np.einsum('tsk,tkp->tsp', bx[:, :, k].astype(np.float64),
                                 aa[:, k].astype(np.float64))
                new = (part.astype(np.float64) + prod.reshape(part.shape)
                       ).astype(np.float32)
                part = np.where(inside, new, part)
        acc = acc + part
    y = acc.reshape(n_tiles, s, cols)[:, :, :tile].transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(y).reshape(s, -1))


@pytest.mark.parametrize("name", list(K3_TOPOLOGIES))
def test_3xtf32_emulation_matches_jax_float64_oneshot(monkeypatch, name):
    """The port's float32 ``oneshot``, its K3 computed as the kernel
    computes it, against the JAX package's float64 ``oneshot`` on the same
    inputs; and the emulation against the plain float32 version."""
    jp, tp = _plans(name)
    x = np.random.default_rng(41).normal(size=(2, 3000)) * 0.5
    want = np.asarray(joneshot.oneshot(jp, jnp.asarray(x)))
    calls = []

    def kernel(*args, **kw):
        y = emulate_k3(*args, **kw)
        calls.append((args, kw, y))
        return y

    monkeypatch.setattr(general, "general_resample", kernel)
    got = gart.oneshot(tp, x.astype(np.float32), device="cpu").numpy()
    assert len(calls) == 1 and calls[0][1]["bands"] is not None
    assert calls[0][1]["warpgroups"] == {"cubic": 1}.get(name, 2)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    (u, m, starts), kw, emu = calls[0]
    kw = {k: v for k, v in kw.items() if k not in ("bands", "warpgroups")}
    ref = general.general_resample_reference(u, m, starts, **kw)
    assert (emu - ref).abs().max().item() <= TOL


def test_emulation_bits_do_not_depend_on_the_streams_or_tiles():
    """The emulated arithmetic of an output depends on M alone: the same
    bits for a stream whatever the other streams, and for a tile whatever
    the other tiles of the launch."""
    m = _tile_matrices("general", 1500)
    rng = np.random.default_rng(8)
    starts = torch.from_numpy(np.sort(rng.integers(0, 900, m.shape[0])))
    x = torch.from_numpy(rng.normal(size=(5, 1400)).astype(np.float32))
    for warpgroups in (1, 2):
        kw = dict(w_band=m.shape[1], tile=m.shape[2], warpgroups=warpgroups)
        whole = emulate_k3(x, m, starts, **kw)
        assert torch.equal(emulate_k3(x[1:3], m, starts, **kw), whole[1:3])
        tail = emulate_k3(x, m[2:], starts[2:], **kw)
        assert torch.equal(tail, whole[:, 2 * kw["tile"]:])
