"""PyTorch port vs JAX package: the time-major kernel (K2) and engine.

On the CPU the port's ``fused_resample_tmajor`` computes its plain version
(``unfold`` along time + ``matmul``); it is held against the JAX package's
Pallas kernel in interpret mode.  The port's ``TimeMajorEngine`` runs on
``device='cpu'`` against the JAX ``TimeMajorEngine`` on the same numpy
inputs: float64 to 1e-12, float32 to 2e-5, with identical lengths.  The
CUDA kernel itself runs only on the card (``test_torch_cuda.py``).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine import TimeMajorEngine as JTimeMajor
from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu.ops import pallas_fused as pf
from go_audio_resampler_tpu_torch.engine import (EngineCore, TimeMajorEngine,
                                                 plan_from_arrays)
from go_audio_resampler_tpu_torch.engine.plan import plan_engine
from go_audio_resampler_tpu_torch.engine.tmajor import _step_banded_tmajor
from go_audio_resampler_tpu_torch.filterdesign import Quality
from go_audio_resampler_tpu_torch.ops import tmajor
from go_audio_resampler_tpu_torch.pipeline import fused as tfused

streaming = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.streaming")

TOL = {np.float32: 2e-5, np.float64: 1e-12}
#: CD->DAT (fused exact-rational), integer decimation, DAT->CD, and the
#: ML-ingest decimation (superframed at block 2048).
PLANS = [(44100, 48000, 3), (96000, 48000, 3), (48000, 44100, 3),
         (48000, 16000, 3)]
BATCH, BLOCK = 3, 2048


def _plans(rates_q):
    jp = jplan_engine(rates_q[0], rates_q[1], JQuality(rates_q[2]))
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


def _cd_dat_operator():
    """(R [p2, wx] float64, ipx, wx, p2) of 44.1k->48k HIGH."""
    eng = EngineCore(plan_engine(44100, 48000, Quality.HIGH), device="cpu",
                     dtype=torch.float64)
    r_t, ipx, wx, p2 = eng._band[:4]
    return r_t.t().contiguous().numpy(), ipx, wx, p2


# -- K2 ------------------------------------------------------------------------

@pytest.mark.parametrize("kf", [1, 2, 3])
@pytest.mark.parametrize("n_frames", [1, 12])
def test_plain_matches_pallas_interpret(kf, n_frames):
    r, ipx, wx, p2 = _cd_dat_operator()
    s = 256
    n = (n_frames - 1) * ipx + wx
    xt = np.random.default_rng(n_frames).normal(size=(n, s)).astype(
        np.float32)
    y_j = np.asarray(pf.fused_resample_tmajor(
        jnp.asarray(xt), jnp.asarray(r, dtype=jnp.float32), ipx=ipx, wx=wx,
        p2=p2, ts=128, kf=kf, interpret=True))
    y_t = tmajor.fused_resample_tmajor(
        torch.from_numpy(xt), torch.from_numpy(r.astype(np.float32)),
        ipx=ipx, wx=wx, p2=p2, n_frames=n_frames, tier="highest").numpy()
    assert y_t.shape == y_j.shape == (n_frames * p2, s)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL[np.float32])


@pytest.mark.parametrize("n_frames", [1, 5])
def test_plain_matches_dense_float64(n_frames):
    r, ipx, wx, p2 = _cd_dat_operator()
    xt = np.random.default_rng(4).normal(size=((n_frames - 1) * ipx + wx + 9,
                                               7))
    y = tmajor.fused_resample_tmajor(torch.from_numpy(xt),
                                     torch.from_numpy(r), ipx=ipx, wx=wx,
                                     p2=p2, n_frames=n_frames,
                                     tier="highest").numpy()
    ref = np.concatenate([r @ xt[m * ipx:m * ipx + wx]
                          for m in range(n_frames)])
    assert y.dtype == np.float64
    np.testing.assert_allclose(y, ref, rtol=0, atol=TOL[np.float64])


def test_wrapper_on_cpu_is_the_plain_version():
    r, ipx, wx, p2 = _cd_dat_operator()
    xt = torch.from_numpy(np.random.default_rng(5).normal(
        size=(15 * ipx + wx, 4)).astype(np.float32))
    rr = torch.from_numpy(r.astype(np.float32))
    before = tmajor.launches
    y = tmajor.fused_resample_tmajor(xt, rr, ipx=ipx, wx=wx, p2=p2,
                                     n_frames=16, tier="highest")
    ref = tmajor.fused_resample_tmajor_reference(xt, rr, ipx=ipx, wx=wx,
                                                 p2=p2, n_frames=16,
                                                 tier="highest")
    assert tmajor.launches == before
    assert torch.equal(y, ref)
    empty = tmajor.fused_resample_tmajor(xt, rr, ipx=ipx, wx=wx, p2=p2,
                                         n_frames=0, tier="highest")
    assert empty.shape == (0, 4)


@pytest.mark.parametrize("kw,match", [
    (dict(n_frames=17), "need xt.shape"),
    (dict(wx=300), "r is"),
    (dict(ipx=0), "ipx=0"),
])
def test_wrapper_rejects_bad_shapes(kw, match):
    _, ipx, wx, p2 = _cd_dat_operator()
    args = dict(ipx=ipx, wx=wx, p2=p2, n_frames=16, tier="highest")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        tmajor.fused_resample_tmajor(torch.zeros((15 * ipx + wx, 2)),
                                     torch.zeros((p2, wx)), **args)


def test_step_counts():
    r, ipx, wx, p2 = _cd_dat_operator()
    eng = EngineCore(plan_engine(44100, 48000, Quality.HIGH), batch=2,
                     device="cpu", dtype=torch.float64)
    carry = torch.zeros((eng._band.carry, 2), dtype=torch.float64)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(ipx * 16, 2)))
    c2, y, n = _step_banded_tmajor(torch.from_numpy(r), carry, x, ipx=ipx,
                                   wx=wx, p2=p2, tier="highest")
    assert n == 16 * p2 and tuple(y.shape) == (16 * p2, 2)
    assert tuple(c2.shape) == (eng._band.carry, 2) and c2.is_contiguous()
    assert torch.equal(c2, x[-eng._band.carry:])


# -- TimeMajorEngine -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates_q", PLANS)
def test_engine_matches_jax(rates_q, dtype):
    jp, tp = _plans(rates_q)
    jt = JTimeMajor(jp, batch=BATCH, block=BLOCK, dtype=dtype)
    tt = TimeMajorEngine(tp, batch=BATCH, block=BLOCK, dtype=dtype,
                         device="cpu")
    mult = tt.chunk_multiple
    assert mult == jt.chunk_multiple and tt.block == jt.block
    n = (7000 // mult) * mult
    x = (np.random.default_rng(7).normal(size=(n, BATCH)) * 0.5).astype(dtype)
    outs_j, outs_t = [], []
    for lo, hi in [(0, 2 * mult), (2 * mult, 2 * mult), (2 * mult, n)]:
        outs_j.append(np.asarray(jt.process_device(jnp.asarray(x[lo:hi]))))
        yt = tt.process_device(torch.from_numpy(x[lo:hi]))
        assert yt.device.type == "cpu" and yt.dtype == tt.dtype
        outs_t.append(yt.numpy())
    outs_j.append(np.asarray(jt.flush_device()))
    outs_t.append(tt.flush_device().numpy())
    yj, yt = np.concatenate(outs_j), np.concatenate(outs_t)
    assert yt.shape == yj.shape == (tp.lengths.canonical(n), BATCH)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=TOL[dtype])
    assert (tt.samples_in, tt.samples_out) == (jt.samples_in, jt.samples_out)


@pytest.mark.parametrize("rates_q", PLANS)
def test_engine_is_the_transpose_of_enginecore(rates_q):
    _, tp = _plans(rates_q)
    x = np.random.default_rng(8).normal(size=(BATCH, 6000))
    eng = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=torch.float64,
                     device="cpu")
    mult = eng.device_chunk_multiple
    n = (x.shape[1] // mult) * mult
    ref = torch.cat([eng.process_device(torch.from_numpy(x[:, :n])),
                     eng.flush_device()], 1).numpy()
    tt = TimeMajorEngine(tp, batch=BATCH, block=BLOCK, dtype=torch.float64,
                         device="cpu")
    got = torch.cat([tt.process_device(torch.from_numpy(x[:, :n].T)),
                     tt.flush_device()], 0).numpy()
    assert got.shape == ref.T.shape
    np.testing.assert_allclose(got, ref.T, rtol=0, atol=TOL[np.float64])


def test_chunked_matches_single_call():
    """Chunking invariance: one call, calls of 8 periods, and the same
    calls again give the same canonical stream (equal widths bit for
    bit)."""
    plan = plan_engine(44100, 48000, Quality.HIGH)
    engines = [TimeMajorEngine(plan, batch=2, block=BLOCK,
                               dtype=torch.float64, device="cpu")
               for _ in range(3)]
    mult = engines[0].chunk_multiple
    n = mult * 40
    xt = torch.from_numpy(np.random.default_rng(9).normal(size=(n, 2)) * 0.5)
    y1 = torch.cat([engines[0].process_device(xt),
                    engines[0].flush_device()])
    parts = []
    for tm in engines[1:]:
        parts.append(torch.cat(
            [tm.process_device(xt[lo:lo + mult * 8])
             for lo in range(0, n, mult * 8)] + [tm.flush_device()]))
    assert y1.shape == parts[0].shape == (plan.lengths.canonical(n), 2)
    np.testing.assert_allclose(parts[0].numpy(), y1.numpy(), rtol=0,
                               atol=TOL[np.float64])
    assert torch.equal(parts[0], parts[1])


@functools.lru_cache(maxsize=None)
def _length_plan(name):
    """44.1k -> 48k (exact-rational), 48k -> 16k (integer decimation) and
    the head-free 192k -> 48k composite of two 2:1 stages, built as
    ``api.Resampler`` builds it (48 kHz-based stage plans)."""
    if name == "192k->48k":
        stages = [plan_engine(48000, 24000, Quality.HIGH)] * 2
        return tfused.BandedPlan(tfused.fuse_chain(stages), 0.25,
                                 latency=sum(p.latency() for p in stages))
    rates = {"44.1k->48k": (44100, 48000), "48k->16k": (48000, 16000)}[name]
    return plan_engine(*rates, Quality.HIGH)


@pytest.mark.parametrize("n,name", [
    pytest.param(n, name,
                 id=str(n) if name == "44.1k->48k" else f"{name}-{n}")
    for name in ("44.1k->48k", "48k->16k", "192k->48k")
    for n in (0, 1, 147, 148, 4704)])
def test_exact_lengths(n, name):
    """The shared drain's canonical total on each fused banded kind that
    ``TimeMajorEngine`` runs: whole chunks of at most ``n`` rows, then
    the flush."""
    plan = _length_plan(name)
    tt = TimeMajorEngine(plan, batch=1, dtype=torch.float64, device="cpu")
    assert plan.kind != "banded" or plan.op.head is None
    rows = (n // tt.chunk_multiple) * tt.chunk_multiple
    x = torch.zeros((rows, 1), dtype=torch.float64)
    y = torch.cat([tt.process_device(x), tt.flush_device()])
    assert y.shape == (plan.lengths.canonical(rows), 1)
    assert tt.estimate_output(n) == plan.estimate_output(n)


def test_steps_go_through_the_k2_wrapper(monkeypatch):
    calls = []
    real = tmajor.fused_resample_tmajor

    def spy(xt, r, **kw):
        calls.append((tuple(xt.shape), kw["n_frames"]))
        return real(xt, r, **kw)

    monkeypatch.setattr(tmajor, "fused_resample_tmajor", spy)
    tt = TimeMajorEngine(plan_engine(48000, 16000, Quality.HIGH), batch=2,
                         device="cpu")
    assert (tt.chunk_multiple, tt.block) == (1536, 3072)
    tt.process_device(torch.zeros((2 * 1536, 2)))
    assert calls == [((tt._carry_len + 2 * 1536, 2), 2)]


@pytest.mark.parametrize("rates,kw", [
    ((44100, 48001, Quality.HIGH), {}),         # non-exact walk
    ((48000, 96000, Quality.HIGH), {}),         # dft_up
    ((44100, 48000, Quality.QUICK), {}),        # cubic
    ((48000, 44099, Quality.HIGH), {"strict_antialias": True}),  # walk + aa
])
def test_rejects_unsupported(rates, kw):
    with pytest.raises(NotImplementedError):
        TimeMajorEngine(plan_engine(*rates, **kw), batch=2, device="cpu")


def test_rejects_fft_decimation(monkeypatch):
    """FFT-routed decimation has no banded matrix: both packages refuse
    it with the same message."""
    monkeypatch.setattr(streaming, "DECIM_FFT_MIN_TAPS", 1)
    monkeypatch.setattr(importlib.import_module(
        "go_audio_resampler_tpu.engine.oneshot"), "DECIM_FFT_MIN_TAPS", 1)
    with pytest.raises(NotImplementedError) as err:
        TimeMajorEngine(plan_engine(48000, 16000, Quality.HIGH), batch=2,
                        device="cpu")
    with pytest.raises(NotImplementedError) as jerr:
        JTimeMajor(jplan_engine(48000.0, 16000.0, JQuality.HIGH), batch=2,
                   dtype=jnp.float32)
    assert str(err.value) == str(jerr.value)
    assert "FFT-routed decimation has no banded matrix" in str(err.value)


def test_validation():
    plan = plan_engine(44100, 48000, Quality.HIGH)
    tm = TimeMajorEngine(plan, batch=2, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        tm.process_device(torch.zeros((5, 2)))
    with pytest.raises(ValueError, match="time-major rows"):
        tm.process_device(torch.zeros((tm.chunk_multiple, 3)))
    assert tm.process_device(torch.zeros((0, 2))).shape == (0, 2)
    tm.flush_device()
    assert tm.flush_device().shape == (0, 2)
    with pytest.raises(RuntimeError, match="after flush"):
        tm.process_device(torch.zeros((tm.chunk_multiple, 2)))
    tm.reset()
    assert tm.process_device(torch.zeros((tm.chunk_multiple, 2))).shape[1] == 2


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TimeMajorEngine(plan_engine(44100, 48000, Quality.HIGH))


@pytest.mark.parametrize("rates", [(44100, 48001, 3), (48000, 96000, 3),
                                   (44100, 48000, 0)])
def test_walk_cubic_dft_up_raise_with_the_jax_message(rates):
    """``EngineCore`` runs the walk, cubic and dft_up; ``TimeMajorEngine``
    refuses them with the JAX package's words."""
    plan = plan_engine(rates[0], rates[1], Quality(rates[2]))
    EngineCore(plan, batch=2, device="cpu")
    with pytest.raises(NotImplementedError) as want:
        JTimeMajor(jplan_engine(rates[0], rates[1], JQuality(rates[2])),
                   batch=2)
    with pytest.raises(NotImplementedError) as got:
        TimeMajorEngine(plan, batch=2, device="cpu")
    assert str(got.value) == str(want.value)
