"""PyTorch port vs JAX package: the FFT overlap-save routes.

The port's ``engine/fftstage.py`` and the FFT branches of its engine and
one-shot run on the CPU (``torch.fft``) against the JAX package's on the
CPU (``jnp.fft``), both fed the same numpy inputs and the same filters
(plans carried across as arrays): the FFT routes to 1e-11 absolute in
float64 (the tolerance of ``tests/test_fftstage.py``; the two pocketfft
builds round differently), host arrays bit-equal, float32 to 1e-5 of
max|y|, lengths equal.  The routes:

- ``fft_correlate`` and ``fft_oneshot`` (decimate and dft_up plans);
- the streaming prefilter step ``_fir_fft_step``, which the walk takes
  for a prefilter of ``FFT_CONV_MIN_TAPS`` taps or more (the real
  7,841-tap prefilter of 44.1k -> 3001 VERY_HIGH), and its one-shot;
- the streaming decimation step ``_fft_decim_step`` and the one-shot's,
  reached by lowering ``DECIM_FFT_MIN_TAPS`` as
  ``tests/test_fft_decim_routing.py`` does.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine import EngineCore as JEngine
from go_audio_resampler_tpu.engine import fftstage as jfft
from go_audio_resampler_tpu.engine import streaming as jstreaming
from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu_torch.engine import (EngineCore, TimeMajorEngine,
                                                 oneshot, plan_from_arrays)
from go_audio_resampler_tpu_torch.engine import fftstage as tfft

joneshot = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")
streaming = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.streaming")

FFT_TOL = 1e-11
F32_TOL = 1e-5
#: tests/test_fftstage.py:19-26: decimate x2 (HIGH, VERY_HIGH), x4, x3;
#: dft_up x2, x4.
PLANS = [(96000, 48000, 3), (96000, 48000, 4), (192000, 48000, 2),
         (48000, 16000, 3), (48000, 96000, 3), (48000, 192000, 2)]


@functools.lru_cache(maxsize=None)
def _plans(a, b, q, aa=False):
    """The JAX plan and the port's, carrying the same filter arrays."""
    jp = jplan_engine(float(a), float(b), JQuality(q), aa)
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


def _long_aa():
    """44.1k -> 3001 VERY_HIGH with the prefilter: 7,841 taps, above
    FFT_CONV_MIN_TAPS, so both packages filter it by FFT."""
    jp, tp = _plans(44100, 3001, 4, True)
    assert tp.kind == "two_stage" and not tp.is_rational_exact
    assert tp.aa_taps == 7841 >= toneshot.FFT_CONV_MIN_TAPS
    return jp, tp


def _close(got, want, tol=FFT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _run(eng, x, splits):
    outs = [eng.process(x[:, a:b]) for a, b in zip(splits[:-1], splits[1:])]
    outs.append(eng.flush())
    return np.concatenate(outs, axis=1)


def _splits(n, rng, k=5):
    return [0] + sorted(int(v) for v in rng.integers(1, n, k)) + [n]


# -- the overlap-save core ------------------------------------------------

@pytest.mark.parametrize("n,taps,count", [(9000, 701, 8000), (50, 11, 50),
                                          (20000, 6145, 13000)])
def test_fft_correlate(n, taps, count):
    """Against the JAX ``fft_correlate`` and ``np.correlate`` (the input
    zero-extended past its end, as the JAX test's short case)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n))
    h = rng.normal(size=taps)
    got = tfft.fft_correlate(torch.from_numpy(x), h, count).numpy()
    _close(got, jfft.fft_correlate(jnp.asarray(x), h, count))
    xp = np.pad(x, ((0, 0), (0, taps)))
    direct = np.stack([np.correlate(r, h, mode="full")[taps - 1:
                                                      taps - 1 + count]
                       for r in xp])
    _close(got, direct, 1e-10)


def test_spectrum_types():
    """The spectrum is the float64 host rfft, rounded once to complex64
    for float32 inputs; a prepared spectrum gives the host taps' bits."""
    h = np.random.default_rng(1).normal(size=300)
    s64 = tfft.spectrum(h, torch.float64, "cpu")
    s32 = tfft.spectrum(h, torch.float32, "cpu")
    assert (s64.taps, s64.n) == (300, 4096) == (s32.taps, s32.n)
    assert s64.H.dtype == torch.complex128 and s32.H.dtype == torch.complex64
    hrev = np.zeros(4096)
    hrev[:300] = h[::-1]
    assert np.array_equal(s64.H.numpy(), np.fft.rfft(hrev))
    assert np.array_equal(s32.H.numpy(),
                          np.fft.rfft(hrev).astype(np.complex64))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 5000)))
    assert torch.equal(tfft.fft_correlate(x, s64, 4000),
                       tfft.fft_correlate(x, h, 4000))
    assert [tfft._fft_len(t) for t in (1, 1024, 1025, 7841)] == [
        jfft._fft_len(t) for t in (1, 1024, 1025, 7841)] == [
        4096, 4096, 8192, 32768]


# -- fft_oneshot ----------------------------------------------------------

@pytest.mark.parametrize("rates_q", PLANS)
def test_fft_oneshot_matches_jax(rates_q):
    jp, tp = _plans(*rates_q)
    x = np.random.default_rng(sum(rates_q)).normal(size=(2, 4096))
    want = np.asarray(jfft.fft_oneshot(jp, x, dtype=np.float64))
    got = tfft.fft_oneshot(tp, x, device="cpu")
    assert got.dtype == torch.float64
    _close(got.numpy(), want)
    # ... and the same stream as the port's oneshot (K1's plain version).
    _close(got.numpy(), oneshot(tp, x, device="cpu").numpy())


@pytest.mark.parametrize("n", [1, 2, 64, 1000, 4097])
def test_fft_oneshot_lengths(n):
    jp, tp = _plans(96000, 48000, 3)
    x = np.random.default_rng(n).normal(size=(1, n))
    got = tfft.fft_oneshot(tp, x, device="cpu").numpy()
    assert got.shape[1] == tp.lengths.canonical(n)
    _close(got, jfft.fft_oneshot(jp, x, dtype=np.float64))


def test_fft_oneshot_empty():
    _, tp = _plans(96000, 48000, 3)
    y = tfft.fft_oneshot(tp, np.zeros((2, 0)), device="cpu")
    assert tuple(y.shape) == (2, 0)


def test_fft_oneshot_float32():
    jp, tp = _plans(96000, 48000, 3)
    x = np.random.default_rng(9).normal(size=(2, 8192)).astype(np.float32)
    want = np.asarray(jfft.fft_oneshot(jp, x, dtype=np.float32))
    got = tfft.fft_oneshot(tp, x, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < F32_TOL


def test_fft_oneshot_rejects_two_stage():
    jp, tp = _plans(44100, 48000, 3)
    with pytest.raises(ValueError, match="long-FIR") as err:
        tfft.fft_oneshot(tp, np.zeros((1, 100)), device="cpu")
    with pytest.raises(ValueError, match="long-FIR") as jerr:
        jfft.fft_oneshot(jp, np.zeros((1, 100)), dtype=np.float64)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="streams, samples"):
        tfft.fft_oneshot(tp, np.zeros(100), device="cpu")


@pytest.mark.parametrize("rates_q", [(48000, 96000, 3), (48000, 192000, 2),
                                     (44100, 88200, 4)])
def test_upsample_prototype_bit_equal(rates_q):
    jp, tp = _plans(*rates_q)
    assert tp.kind == "dft_up"
    got = tfft._upsample_prototype(tp)
    assert got.dtype == np.float64
    assert np.array_equal(got, jfft._upsample_prototype(jp))


# -- the streaming steps ----------------------------------------------------

def test_fir_fft_step_matches_jax():
    """``_fir_fft_step`` against the JAX step and the port's banded FIR
    (``stages.fir_process``): the same carry, the same outputs."""
    from go_audio_resampler_tpu_torch.engine import stages
    rng = np.random.default_rng(4)
    taps = 6145
    h = rng.normal(size=taps) / taps
    carry = rng.normal(size=(2, taps - 1))
    x = rng.normal(size=(2, 1024))
    spec = tfft.spectrum(h, torch.float64, "cpu")
    c, y = streaming._fir_fft_step(spec, torch.from_numpy(carry),
                                   torch.from_numpy(x))
    jc, jy = jstreaming._fir_fft_step(h, jnp.asarray(carry), jnp.asarray(x))
    _close(y.numpy(), jy)
    assert np.array_equal(c.numpy(), np.asarray(jc))
    bc, by = stages.fir_process(torch.from_numpy(h), torch.from_numpy(carry),
                                torch.from_numpy(x), "highest")
    _close(y.numpy(), by.numpy())
    assert torch.equal(c, bc)


@pytest.mark.parametrize("rates_q", [(96000, 48000, 4), (48000, 16000, 3)])
def test_fft_decim_step_matches_jax(rates_q):
    jp, tp = _plans(*rates_q)
    rng = np.random.default_rng(5)
    m, t = tp.factor, tp.decim_taps
    carry = rng.normal(size=(2, -(-(t - 1) // m) * m))
    x = rng.normal(size=(2, 512 * m))
    spec = tfft.spectrum(tp.decim_coeffs, torch.float64, "cpu")
    c, y, n = streaming._fft_decim_step(spec, m, torch.from_numpy(carry),
                                        torch.from_numpy(x))
    jc, jy, jn = jstreaming._fft_decim_step(np.asarray(jp.decim_coeffs), m,
                                            jnp.asarray(carry),
                                            jnp.asarray(x))
    assert n == int(jn) == 512 and y.shape[1] == 512
    _close(y.numpy(), jy)
    assert np.array_equal(c.numpy(), np.asarray(jc))


# -- the FFT prefilter: EngineCore and oneshot --------------------------------

@pytest.fixture(scope="module")
def aa_stream():
    """The JAX engine's stream of 44.1k -> 3001 VERY_HIGH with the 7,841-tap
    prefilter, and the input: 2 streams of 20,000 samples."""
    jp, _ = _long_aa()
    x = np.random.default_rng(6).normal(size=(2, 20000)) * 0.5
    je = JEngine(jp, batch=2, block=2048, dtype=jnp.float64)
    assert getattr(je._fir_fn, "func", None) is not jstreaming._step_fir
    return x, np.concatenate([je.process(x), je.flush()], axis=1)


def test_engine_fft_prefilter_matches_jax(aa_stream, monkeypatch):
    """The walk behind the FFT prefilter, in random chunks; the spectrum
    is computed once, when the engine is built, and never in a step."""
    x, want = aa_stream
    _, tp = _long_aa()
    calls = []
    real = tfft.spectrum

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tfft, "spectrum", spy)
    te = EngineCore(tp, batch=2, block=2048, dtype=torch.float64,
                    device="cpu")
    assert te._has_aa and te._aa_spec is not None and te._aa_band is None
    assert calls == [1]
    got = _run(te, x, _splits(20000, np.random.default_rng(7)))
    assert calls == [1]
    assert got.shape[1] == tp.lengths.canonical(20000)
    _close(got, want)


def test_oneshot_fft_prefilter_matches_jax():
    jp, tp = _long_aa()
    x = np.random.default_rng(5).normal(size=(1, 3000)) * 0.5
    aux = toneshot._oneshot_aux(tp, 3000, torch.float64, "cpu", "highest")
    assert isinstance(aux[4], tfft.Spectrum) and aux[5] is None
    got = oneshot(tp, x, device="cpu").numpy()
    _close(got, np.asarray(joneshot.oneshot(jp, x, dtype=np.float64)))


def test_oneshot_fft_prefilter_float32():
    jp, tp = _long_aa()
    x = (np.random.default_rng(8).normal(size=(2, 3000)) * 0.5).astype(
        np.float32)
    want = np.asarray(joneshot.oneshot(jp, x, dtype=np.float32))
    got = oneshot(tp, x, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < F32_TOL


# -- FFT-routed decimation (crossover lowered) --------------------------------

@pytest.fixture
def lowered(monkeypatch):
    """Both packages' decimation crossover lowered to 0 (the JAX one-shot's
    jit cache cleared around it, as tests/test_fft_decim_routing.py does)."""
    monkeypatch.setattr(toneshot, "DECIM_FFT_MIN_TAPS", 0)
    monkeypatch.setattr(streaming, "DECIM_FFT_MIN_TAPS", 0)
    monkeypatch.setattr(joneshot, "DECIM_FFT_MIN_TAPS", 0)
    joneshot._oneshot_jit.clear_cache()
    yield
    joneshot._oneshot_jit.clear_cache()


@pytest.mark.parametrize("rates_q", [(96000, 48000, 4), (48000, 4000, 4)])
def test_engine_fft_decimation_matches_jax(rates_q, lowered):
    jp, tp = _plans(*rates_q)
    x = np.random.default_rng(3).normal(size=(2, 30000))
    je = JEngine(jp, batch=2, block=2048, dtype=jnp.float64)
    assert je._decim_fft
    want = np.concatenate([je.process(x), je.flush()], axis=1)
    te = EngineCore(tp, batch=2, block=2048, dtype=torch.float64,
                    device="cpu")
    assert te._decim_fft is not None and te._band is None
    assert (te.block, te.device_chunk_multiple) == (je.block,
                                                    je.device_chunk_multiple)
    assert te._drop == je._drop_override
    got = _run(te, x, _splits(30000, np.random.default_rng(4)))
    assert got.shape[1] == tp.lengths.canonical(30000)
    _close(got, want)


def test_engine_fft_decimation_device_mode(lowered):
    """``process_device``/``flush_device`` and ``stream`` on the FFT step
    (tests/test_fft_decim_routing.py::test_fft_step_supports_device_mode),
    against the JAX engine's device mode."""
    jp, tp = _plans(48000, 4000, 4)
    je = JEngine(jp, batch=1, block=2048, dtype=jnp.float64)
    mult = je.device_chunk_multiple
    assert mult == tp.factor == 12
    x = np.random.default_rng(3).normal(size=(1, 10 * 2048))
    n = (x.shape[1] // mult) * mult
    want = np.concatenate([np.asarray(je.process_device(jnp.asarray(
        x[:, :n]))), np.asarray(je.flush_device())], axis=1)
    te = EngineCore(tp, batch=1, block=2048, dtype=torch.float64,
                    device="cpu")
    assert te.device_chunk_multiple == mult
    got = torch.cat([te.process_device(torch.from_numpy(x[:, :n])),
                     te.flush_device()], dim=1).numpy()
    _close(got, want)
    te.reset()
    streamed = np.concatenate(list(te.stream(
        [x[:, :5000], x[:, 5000:n]])), axis=1)
    _close(streamed, want)


def test_oneshot_fft_decimation_matches_jax(lowered):
    jp, tp = _plans(48000, 4000, 4)
    x = np.random.default_rng(3).normal(size=(2, 13000))
    aux = toneshot._oneshot_aux(tp, 13000, torch.float64, "cpu", "highest")
    assert len(aux) == 1 and isinstance(aux[0], tfft.Spectrum)
    got = oneshot(tp, x, device="cpu").numpy()
    _close(got, np.asarray(joneshot.oneshot(jp, x, dtype=np.float64)))


def test_tmajor_refuses_fft_decimation(lowered):
    _, tp = _plans(96000, 48000, 4)
    with pytest.raises(NotImplementedError, match="no banded matrix"):
        TimeMajorEngine(tp, batch=2, device="cpu")
