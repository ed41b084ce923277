"""PyTorch port vs JAX package: the convenience API (``convenience.py``)
on the CPU.

The direct engines (``new_engine``, ``new_engine_float32``), the one-shot
helpers (``resample_mono/stereo[_float32]``, on the port's ``oneshot``:
K1 or K3 on the card, their plain versions here), the pipeline
constructors and the interleave helpers, each against the JAX package's
with the same inputs: float64 within 1e-12, float32 within 1e-5 of
max|y|, equal lengths, dtypes and errors.  On the CPU the port's float64
entry points compute in float64, as the JAX package's do under x64.
"""

import numpy as np
import pytest
import torch

import go_audio_resampler_tpu as jar
import go_audio_resampler_tpu_torch as tar
from go_audio_resampler_tpu import convenience as jconv
from go_audio_resampler_tpu_torch import convenience as tconv

TOL = 1e-12
F32_TOL = 1e-5
#: (input rate, output rate, preset): rational (K1), decimation (K1),
#: dft_up (K1), a non-exact ratio (K3), and LOW.
RATES = [(44100, 48000, 3), (48000, 16000, 3), (48000, 96000, 4),
         (44100, 48001, 3), (48000, 44100, 1)]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _close32(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def _sig(n, seed=0):
    return np.random.default_rng(seed).normal(size=n) * 0.5


@pytest.mark.parametrize("rates", RATES)
def test_resample_mono_equal(rates):
    inr, outr, q = rates
    x = _sig(3000, 1)
    got = tar.resample_mono(x, inr, outr, q, device="cpu")
    _close(got, jar.resample_mono(x, inr, outr, q))
    _close32(tar.resample_mono_float32(x.astype(np.float32), inr, outr, q,
                                       device="cpu"),
             jar.resample_mono_float32(x.astype(np.float32), inr, outr, q))


@pytest.mark.parametrize("rates", RATES[:2])
def test_resample_stereo_equal(rates):
    inr, outr, q = rates
    left, right = _sig(2500, 2), _sig(2500, 3)
    for got, want in zip(tar.resample_stereo(left, right, inr, outr, q,
                                             device="cpu"),
                         jar.resample_stereo(left, right, inr, outr, q)):
        _close(got, want)
    # both channels ride one call: each equals its own mono run
    lo, ro = tar.resample_stereo(left, right, inr, outr, q, device="cpu")
    assert np.array_equal(lo, tar.resample_mono(left, inr, outr, q,
                                                device="cpu"))
    f32 = [c.astype(np.float32) for c in (left, right)]
    for got, want in zip(tar.resample_stereo_float32(*f32, inr, outr, q,
                                                     device="cpu"),
                         jar.resample_stereo_float32(*f32, inr, outr, q)):
        _close32(got, want)


def test_resample_stereo_unequal_lengths():
    left, right = _sig(3000, 4), _sig(2000, 5)
    got = tar.resample_stereo(left, right, 44100, 48000, device="cpu")
    want = jar.resample_stereo(left, right, 44100, 48000)
    assert len(got[0]) != len(got[1])
    for g, w in zip(got, want):
        _close(g, w)
    got = tar.resample_stereo_float32(left.astype(np.float32),
                                      right.astype(np.float32), 44100,
                                      48000, device="cpu")
    assert [len(c) for c in got] == [len(c) for c in want]


@pytest.mark.parametrize("rates", RATES)
def test_new_engine_equal(rates):
    """The float64 direct engine in chunks, then flush; its statistics."""
    inr, outr, q = rates
    x = _sig(6000, 6)
    ej = jar.new_engine(inr, outr, q)
    et = tar.new_engine(inr, outr, q, device="cpu")
    assert et.engine.dtype == torch.float64
    outs = []
    for e in (ej, et):
        ys = [e.process(x[a:a + 1700]) for a in range(0, 6000, 1700)]
        ys.append(e.flush())
        outs.append(np.concatenate(ys))
    _close(outs[1], outs[0])
    assert et.get_statistics() == ej.get_statistics()
    assert (et.get_ratio(), et.estimate_output(1000)) == (
        ej.get_ratio(), ej.estimate_output(1000))


@pytest.mark.parametrize("rates", RATES[:2])
def test_new_engine_float32_equal(rates):
    inr, outr, q = rates
    x = _sig(6000, 7).astype(np.float32)
    ej = jar.new_engine_float32(inr, outr, q)
    et = tar.new_engine_float32(inr, outr, q, device="cpu")
    want = np.concatenate([ej.process(x), ej.flush()])
    got = np.concatenate([et.process(x), et.flush()])
    _close32(got, want)
    et.reset()
    assert np.array_equal(np.concatenate([et.process(x), et.flush()]), got)


def test_hq_interp_engine_equal():
    x = _sig(4000, 8)
    ej = jar.new_engine(44100, 48001, hq_interp=True)
    et = tar.new_engine(44100, 48001, hq_interp=True, device="cpu")
    _close(np.concatenate([et.process(x), et.flush()]),
           np.concatenate([ej.process(x), ej.flush()]))


def test_direct_engine_process_into():
    """BufferTooSmallError before any state advance; a buffer of
    estimate_output(n) always suffices, the excess queued."""
    x = _sig(4000, 9)
    got = []
    for pkg, e in ((jar, jar.new_engine(44100, 48000)),
                   (tar, tar.new_engine(44100, 48000, device="cpu"))):
        with pytest.raises(pkg.BufferTooSmallError):
            e.process_into(x[:512], np.zeros(3))
        assert e.get_statistics()["samplesIn"] == 0
        ys = []
        for a in range(0, 4000, 300):
            out = np.zeros(e.estimate_output(len(x[a:a + 300])))
            k = e.process_into(x[a:a + 300], out)
            assert k <= len(out)
            ys.append(out[:k].copy())
        ys.append(e.flush())
        got.append(np.concatenate(ys))
    _close(got[1], got[0])


@pytest.mark.parametrize("ctor,args", [
    ("new_cd_to_dat", ()), ("new_dat_to_cd", ()), ("new_cd_to_hires", ()),
    ("new_hires_to_cd", ()), ("new_simple", (48000, 32000)),
    ("new_stereo", (44100, 48000)), ("new_multi_channel", (96000, 44100, 3)),
])
def test_pipeline_constructors_equal(ctor, args):
    rj = getattr(jar, ctor)(*args)
    rt = getattr(tar, ctor)(*args, device="cpu")
    assert rt.device.type == "cpu" and rt.dtype == rj.dtype
    assert (rt.config.input_rate, rt.config.output_rate,
            rt.config.channels) == (rj.config.input_rate,
                                    rj.config.output_rate,
                                    rj.config.channels)
    assert [s.type.name for s in rt.pipeline.stages] == [
        s.type.name for s in rj.pipeline.stages]
    assert [getattr(e.plan, "kind", "?") for e in rt._exec] == [
        getattr(e.plan, "kind", "?") for e in rj._exec]


def test_constants_and_presets():
    names = ["RATE_CD", "RATE_DAT", "RATE_HIRES_88", "RATE_HIRES_96",
             "RATE_HIRES_176", "RATE_HIRES_192", "RATE_TELEPHONY",
             "RATE_VOIP", "RATE_SPEECH", "RATE_VIDEO"]
    assert [getattr(tar, n) for n in names] == [getattr(jar, n)
                                                for n in names]
    for p in tar.QualityPreset:
        assert int(tconv.preset_to_engine_quality(p)) == int(
            jconv.preset_to_engine_quality(int(p)))


def test_interleave_equal():
    left, right = np.arange(10.0), -np.arange(7.0)
    inter = tar.interleave_to_stereo(left, right)
    assert np.array_equal(inter, jar.interleave_to_stereo(left, right))
    assert len(inter) == 14
    for got, want in zip(tar.deinterleave_from_stereo(inter),
                         jar.deinterleave_from_stereo(inter)):
        assert np.array_equal(got, want)
    assert tar.interleave_to_stereo_float32 is tar.interleave_to_stereo
    assert tar.deinterleave_from_stereo_float32 is \
        tar.deinterleave_from_stereo


def test_new_variable_rate_not_ported():
    """``new_variable_rate`` returns the port's resampler, built as the
    JAX package builds its own."""
    from go_audio_resampler_tpu_torch.engine import VariableRateResampler
    want = jar.new_variable_rate(44100, 48000, output_rate=44100,
                                 channels=2, hq=True)
    got = tar.new_variable_rate(44100, 48000, output_rate=44100, channels=2,
                                hq=True, device="cpu")
    assert isinstance(got, VariableRateResampler)
    assert ((got.max_ratio, got.get_io_ratio(), got.batch, got.quality,
             got.dtype) == (want.max_ratio, want.get_io_ratio(), want.batch,
                            want.quality, want.dtype))


def test_defaults_run_on_the_card():
    """Without ``device`` every entry point asks for the card."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is valid")
    for call in (lambda: tar.new_engine(44100, 48000),
                 lambda: tar.new_engine_float32(44100, 48000),
                 lambda: tar.resample_mono(np.zeros(100), 44100, 48000),
                 lambda: tar.resample_stereo(np.zeros(100), np.zeros(100),
                                             44100, 48000),
                 lambda: tar.new_cd_to_dat()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_compute_dtype_on_the_card():
    """The float64 entry points compute in float32 on the card (as the JAX
    package does on a TPU) and return float64."""
    assert tconv._compute_dtype(np.float64, "cuda") == np.float32
    assert tconv._compute_dtype(np.float32, "cuda") == np.float32
    assert tconv._compute_dtype(np.float64, "cpu") == np.float64
    assert tconv._compute_dtype(np.float32, "cpu") == np.float32


def test_package_exports():
    """The JAX package's exports, all of them."""
    assert set(jar.__all__) - set(tar.__all__) == set()
    assert set(tar.__all__) - set(jar.__all__) == {"TimeMajorEngine",
                                                   "Quality"}
    for name in tar.__all__:
        assert getattr(tar, name) is not None, name
    # The subpackages, each with the JAX namesake's exports: engine (the
    # port adds plan_from_arrays, which its checkpoints use), parallel
    # (imported as a subpackage, as in the JAX package), utils and cli.
    import importlib
    sub = {m: (importlib.import_module(f"go_audio_resampler_tpu.{m}"),
               importlib.import_module(f"go_audio_resampler_tpu_torch.{m}"))
           for m in ("engine", "parallel", "utils")}
    jeng, teng = sub["engine"]
    assert set(jeng.__all__) - set(teng.__all__) == set()
    assert set(teng.__all__) - set(jeng.__all__) == {"plan_from_arrays"}
    assert teng.fft_oneshot is not None
    for m in ("parallel", "utils"):
        assert sub[m][1].__all__ == sub[m][0].__all__, m
    for name in ("analyze_filter", "resample_info", "resample_wav"):
        assert callable(importlib.import_module(
            f"go_audio_resampler_tpu_torch.cli.{name}").run)
    for name in ("wav", "roofline"):
        importlib.import_module(f"go_audio_resampler_tpu_torch.utils.{name}")
