"""PyTorch port vs JAX package: ``dispatch='tune'``, ``EngineCore.core_fn``
and ``ops.set_conv_impl``.

- The tune's methodology (``_slope_measure``, ``_slope_pick``) against the
  JAX functions on seeded fake timers, exactly; its cache, key, noise
  refusal and forced flow mirrored from tests/test_precision_tier.py's
  ``TestTuneMethodology``, ``TestTunePersistence`` and
  ``TestTuneNoiseRefusal``.  The forced flow patches the one seam that
  gates measurement on the card (``streaming._tune_measures``), so that
  both lowerings run as eager chains on CPU tensors.
- Off the card the tune gives 'auto' without measuring, as the JAX
  engine's does off the TPU: the streams of both packages' tuned
  engines, the API's and the CLI's agree.
- ``core_fn`` of every topology iterated from ``_init_state()`` in both
  packages, float64, 1e-12.
- ``set_conv_impl`` under each lowering in both packages, float64, 1e-12.

The tune on the card is checked by ``chip_smoke.py`` (phase 15).
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_audio_resampler_tpu as jar
import go_audio_resampler_tpu_torch as tar
from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.engine.streaming import EngineCore as JEngine
from go_audio_resampler_tpu.engine.tmajor import TimeMajorEngine as JTMajor
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu.ops import convolve as jconv
from go_audio_resampler_tpu.pipeline import fused as jfused
from go_audio_resampler_tpu_torch.cli import resample_wav as t_wav
from go_audio_resampler_tpu_torch.engine import (EngineCore, TimeMajorEngine,
                                                 plan_from_arrays)
from go_audio_resampler_tpu_torch.ops import convolve as tconv
from go_audio_resampler_tpu_torch.ops import fused
from go_audio_resampler_tpu_torch.pipeline import fused as tfused
from go_audio_resampler_tpu_torch.utils.wav import WavWriter

jstreaming = importlib.import_module("go_audio_resampler_tpu.engine.streaming")
joneshot = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
streaming = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.streaming")

TOL = dict(rtol=0, atol=1e-12)
HIGH = 3
BATCH, BLOCK = 2, 512


def _plans(a, b, q=HIGH, strict=False):
    jp = jplan_engine(float(a), float(b), JQuality(q), strict)
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


def _composite(stages):
    """(JAX BandedPlan, port BandedPlan) of a chain of 48 kHz-based stage
    plans, as ``api.Resampler._build_exec`` builds it."""
    pairs = [_plans(*s) for s in stages]
    jop = jfused.fuse_chain([j for j, _ in pairs])
    ratio = float(np.prod([j.ratio for j, _ in pairs]))
    latency = sum(j.latency() for j, _ in pairs)
    top = tfused.banded_op_from_arrays(
        {f: getattr(jop, f) for f in ("P", "I", "W", "R", "lam", "lengths",
                                      "head")})
    return (jfused.BandedPlan(jop, ratio, latency=latency),
            tfused.BandedPlan(top, ratio, latency=latency))


def _cd_dat():
    return _plans(44100, 48000)[1]


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh tune cache file for the test."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("GAR_TUNE_CACHE_FILE", str(path))
    return path


@pytest.fixture
def forced(monkeypatch, cache):
    """The tune measures on the CPU (eager chains), into a fresh cache."""
    monkeypatch.setattr(streaming, "_tune_measures", lambda device: True)
    return cache


# -- methodology --------------------------------------------------------------

def _fake_fns(seed: int):
    """A deterministic clock and 2-3 variants of random fixed and per-step
    costs with injected noise, from ``seed``; (fns, timer)."""
    rng = np.random.default_rng(seed)
    clock = [0.0]
    names = ["pallas", "xla", "third"][:int(rng.integers(2, 4))]
    costs = {m: (float(rng.uniform(0, 1e-2)), float(rng.uniform(1e-6, 1e-4)))
             for m in names}
    noise = float(rng.choice([0.0, 1e-6, 1e-4]))

    def mk(fixed, per_step):
        def f(n):
            clock[0] += fixed + per_step * n + noise * float(rng.random())
        return f

    return {m: mk(*c) for m, c in costs.items()}, lambda: clock[0]


@pytest.mark.parametrize("seed", range(20))
def test_slope_measure_matches_jax(seed):
    fns, timer = _fake_fns(seed)
    got = streaming._slope_measure(fns, (4, 36), timer=timer)
    fns, timer = _fake_fns(seed)
    want = jstreaming._slope_measure(fns, (4, 36), timer=timer)
    assert got == want
    fns, timer = _fake_fns(seed)
    assert streaming._slope_pick(fns, (4, 36), timer=timer) == want[0]


def test_slope_pick_cancels_fixed_cost():
    """A variant with a huge fixed per-call cost but a small marginal cost
    wins: the slope cancels the fixed part."""
    clock = [0.0]

    def mk(fixed, per_step):
        def f(n):
            clock[0] += fixed + per_step * n
        return f

    fns = {"low_slope": mk(100.0, 0.001), "low_fixed": mk(0.1, 1.0)}
    assert streaming._slope_pick(fns, (4, 36),
                                 timer=lambda: clock[0]) == "low_slope"


def test_slope_pick_uses_multi_step_launches():
    calls = {"a": [], "b": []}
    fns = {k: (lambda k: lambda n: calls[k].append(n))(k) for k in calls}
    streaming._slope_pick(fns, (4, 36), iters=2)
    for k, seen in calls.items():
        assert set(seen) == {4, 36} and min(seen) > 1, (k, seen)


def test_slope_measure_reports_contrast_and_jitter():
    clock = [0.0]

    def mk(fixed, per_step):
        def f(n):
            clock[0] += fixed + per_step * n
        return f

    fns = {"fast": mk(1.0, 0.001), "slow": mk(1.0, 0.002)}
    winner, contrast, jitter = streaming._slope_measure(
        fns, (4, 36), timer=lambda: clock[0])
    assert winner == "fast"
    assert contrast == pytest.approx(0.001 * 32)
    assert jitter == pytest.approx(0.0)


def test_tune_constants_match_jax():
    assert EngineCore.TUNE_DEPTHS == JEngine.TUNE_DEPTHS == (4, 36)
    assert EngineCore.TUNE_NOISE_FACTOR == JEngine.TUNE_NOISE_FACTOR == 2.0


# -- the forced flow ----------------------------------------------------------

@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000)])
def test_tune_flow_runs_on_forced_measurement(forced, rates):
    """Both lowerings run as eager chains of core_fn steps at both depths;
    the outcome is a pin or the noise refusal, never 'tune', and the
    stream is the 'auto' engine's."""
    tp = _plans(*rates)[1]
    eng = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                     device="cpu", dispatch="tune")
    assert eng.dispatch in ("pallas", "xla", "auto")
    rec = eng.tune_record
    assert rec["source"] == "measured" and rec["graphs"] == 0
    assert set(rec["marginal_ms"]) == {"pallas", "xla"}
    assert rec["pin"] == eng.dispatch
    x = np.random.default_rng(1).normal(size=(BATCH, 3000))
    ref = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                     device="cpu")
    assert np.array_equal(
        np.concatenate([eng.process(x), eng.flush()], axis=1),
        np.concatenate([ref.process(x), ref.flush()], axis=1))


def test_tune_chains_step_from_the_zero_state(forced, monkeypatch):
    """Each lowering's chain runs core_fn at its pin, from _init_state()
    on a [batch, block] zero block, at both depths, once before timing."""
    seen = []
    real = streaming._fused_banded_step

    def spy(r_t, carry, x, **kw):
        seen.append((kw["dispatch"], tuple(x.shape), float(x.abs().max())))
        return real(r_t, carry, x, **kw)

    monkeypatch.setattr(streaming, "_fused_banded_step", spy)
    monkeypatch.setattr(streaming, "_slope_measure",
                        lambda fns, depths, iters=5, timer=None:
                        ("xla", 1.0, 0.0))
    eng = EngineCore(_cd_dat(), batch=BATCH, block=BLOCK, dtype=np.float64,
                     device="cpu", dispatch="tune")
    assert eng.dispatch == "xla"
    for mode in ("pallas", "xla"):
        steps = [s for s in seen if s[0] == mode]
        assert len(steps) == sum(EngineCore.TUNE_DEPTHS)
        assert {s[1:] for s in steps} == {((BATCH, eng.block), 0.0)}


def test_an_error_in_a_lowering_propagates(forced, monkeypatch):
    """No hidden fallback: a failing kernel lowering fails the constructor
    with its own error, and nothing is cached."""
    class KernelFailed(RuntimeError):
        pass

    def boom(*a, **kw):
        raise KernelFailed("launch failed")

    monkeypatch.setattr(fused, "fused_resample", boom)
    with pytest.raises(KernelFailed, match="launch failed"):
        EngineCore(_cd_dat(), batch=BATCH, block=BLOCK, dtype=np.float64,
                   device="cpu", dispatch="tune")
    assert not forced.exists()


def test_no_banded_step_gives_auto_without_measuring(forced, monkeypatch):
    monkeypatch.setattr(streaming, "_Chain", None)
    for rates_q in [(44100, 48001, HIGH), (44100, 48000, 0),
                    (48000, 96000, HIGH)]:
        eng = EngineCore(_plans(*rates_q)[1], batch=BATCH, block=BLOCK,
                         dtype=np.float64, device="cpu", dispatch="tune")
        assert eng.dispatch == "auto"
        assert eng.tune_record["source"] == "no banded step"


# -- persistence --------------------------------------------------------------

def test_cache_roundtrip(cache):
    assert streaming._tune_cache_get("k") is None
    streaming._tune_cache_put("k", "pallas")
    assert streaming._tune_cache_get("k") == "pallas"
    streaming._tune_cache_put("k2", "xla")
    assert streaming._tune_cache_get("k") == "pallas"
    assert streaming._tune_cache_get("k2") == "xla"
    assert json.loads(cache.read_text()) == {"k": "pallas", "k2": "xla"}
    assert [p.name for p in cache.parent.iterdir()] == ["tune.json"]


def test_cache_disabled_by_empty_env(monkeypatch):
    monkeypatch.setenv("GAR_TUNE_CACHE_FILE", "")
    assert streaming._tune_cache_path() is None
    streaming._tune_cache_put("k", "pallas")
    assert streaming._tune_cache_get("k") is None


def test_cache_default_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("GAR_TUNE_CACHE_FILE", raising=False)
    got, want = streaming._tune_cache_path(), jstreaming._tune_cache_path()
    assert got.endswith("go_audio_resampler_tpu_torch/tune.json")
    assert got != want


def test_corrupt_cache_reads_as_none(cache):
    cache.write_text("{not json")
    assert streaming._tune_cache_get("k") is None
    cache.write_text("[1, 2]")
    assert streaming._tune_cache_get("k") is None
    streaming._tune_cache_put("k", "xla")
    assert streaming._tune_cache_get("k") == "xla"


@pytest.mark.parametrize("entry", ["xla", {"winner": "xla",
                                           "contrast_s": 1e-2,
                                           "jitter_s": 1e-4}])
def test_seeded_cache_pins_without_measuring(forced, monkeypatch, entry):
    """A legacy string entry and a dict entry both pin, with the chain
    builder patched to raise: a hit captures nothing."""
    probe = EngineCore(_cd_dat(), batch=BATCH, block=2048, dtype=np.float32,
                       device="cpu")
    streaming._tune_cache_put(probe._tune_key(), entry)

    def no_chain(*a, **kw):
        raise AssertionError("a cache hit must not build a chain")

    monkeypatch.setattr(streaming, "_Chain", no_chain)
    eng = EngineCore(_cd_dat(), batch=BATCH, block=2048, dtype=np.float32,
                     device="cpu", dispatch="tune")
    assert eng.dispatch == "xla"
    assert eng.tune_record["source"] == "cache"
    assert eng.tune_record["graphs"] == 0


def test_key_separates_plan_shapes_dtype_and_resolved_tier(monkeypatch):
    def key(plan=None, **kw):
        kw = {"batch": 2, "block": 2048, "dtype": np.float32, **kw}
        return EngineCore(plan or _cd_dat(), device="cpu", **kw)._tune_key()

    base = key()
    assert key() == base
    assert key(plan=_plans(48000, 44100)[1]) != base
    assert key(batch=3) != base
    assert key(block=4096) != base
    assert key(dtype=np.float64) != base
    assert key(precision="default") != base
    # The resolved tier, not the knob: 'auto' under the process-wide
    # 'high' is the 'high' engine's key, and not the 'auto' one's.
    monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "high")
    assert key() == key(precision="high") != base


def test_key_carries_version_and_kernel_tokens():
    key = EngineCore(_cd_dat(), batch=2, block=2048, dtype=np.float32,
                     device="cpu")._tune_key()
    from go_audio_resampler_tpu_torch.ops import _build
    assert tar.__version__ in key and torch.__version__ in key
    assert repr(torch.version.cuda) in key
    for name in ("fused_resample", "fused_resample_tmajor"):
        assert _build.library_path(name).name in key
    assert "'cpu'" in key


# -- the noise refusal ----------------------------------------------------------

def _tune_with_fake_measure(monkeypatch, contrast, jitter):
    monkeypatch.setattr(
        streaming, "_slope_measure",
        lambda fns, depths, iters=5, timer=None: ("pallas", contrast, jitter))
    return EngineCore(_cd_dat(), batch=1, block=BLOCK, dtype=np.float32,
                      device="cpu", dispatch="tune")


def test_low_contrast_falls_back_and_does_not_write(forced, monkeypatch):
    eng = _tune_with_fake_measure(monkeypatch, contrast=1e-6, jitter=1e-3)
    assert eng.dispatch == "auto"
    assert eng.tune_record["source"] == "measured"
    assert not forced.exists(), "a low-contrast tune must persist nothing"


def test_high_contrast_pins_and_records_margin(forced, monkeypatch):
    eng = _tune_with_fake_measure(monkeypatch, contrast=1e-2, jitter=1e-4)
    assert eng.dispatch == "pallas"
    data = json.loads(forced.read_text())
    assert list(data) == [eng._tune_key()]
    entry = data[eng._tune_key()]
    assert entry == {"winner": "pallas", "contrast_s": 1e-2,
                     "jitter_s": 1e-4}
    again = EngineCore(_cd_dat(), batch=1, block=BLOCK, dtype=np.float32,
                       device="cpu", dispatch="tune")
    assert again.dispatch == "pallas"
    assert again.tune_record["source"] == "cache"


def test_persist_false_writes_nothing(forced, monkeypatch):
    monkeypatch.setattr(
        streaming, "_slope_measure",
        lambda fns, depths, iters=5, timer=None: ("xla", 1e-2, 1e-4))
    eng = EngineCore(_cd_dat(), batch=1, block=BLOCK, dtype=np.float32,
                     device="cpu")
    assert eng._tune_dispatch(persist=False) == "xla"
    assert eng.dispatch == "auto"
    assert not forced.exists()


# -- off the card: 'auto', the JAX engine's stream ------------------------------

OFF_CARD = {
    "44.1k-48k": lambda: _plans(44100, 48000),
    "48k-16k": lambda: _plans(48000, 16000),
    "96k-44.1k": lambda: _composite([(48000, 24000), (48000, 44100, HIGH,
                                                      True)]),
}


@pytest.mark.parametrize("name", list(OFF_CARD))
def test_tune_off_the_card_matches_jax(cache, name, monkeypatch):
    monkeypatch.setattr(streaming, "_Chain", None)
    jp, tp = OFF_CARD[name]()
    x = np.random.default_rng(7).normal(size=(BATCH, 5000))
    je = JEngine(jp, batch=BATCH, block=BLOCK, dtype=jnp.float64,
                 dispatch="tune")
    te = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                    device="cpu", dispatch="tune")
    assert te.dispatch == je.dispatch == "auto"
    assert te.tune_record == {"pin": "auto", "source": "off the card",
                              "graphs": 0}
    want = np.concatenate([np.asarray(je.process(x)),
                           np.asarray(je.flush())], axis=1)
    got = np.concatenate([te.process(x), te.flush()], axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    assert not cache.exists()


def test_tmajor_tune_off_the_card_matches_jax():
    jp, tp = _plans(44100, 48000)
    je = JTMajor(jp, batch=BATCH, block=BLOCK, dtype=jnp.float64,
                 dispatch="tune")
    te = TimeMajorEngine(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                         device="cpu", dispatch="tune")
    assert te.dispatch == je.dispatch == "auto"
    n = 20 * te.chunk_multiple
    xt = np.random.default_rng(8).normal(size=(n, BATCH))
    want = np.concatenate([np.asarray(je.process_device(jnp.asarray(xt))),
                           np.asarray(je.flush_device())], axis=0)
    got = torch.cat([te.process_device(torch.from_numpy(xt)),
                     te.flush_device()]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_config_tune_matches_jax():
    def config(pkg, **kw):
        return pkg.Config(44100, 48000, channels=BATCH, dispatch="tune",
                          quality=pkg.QualitySpec(
                              preset=pkg.QualityPreset(3)), **kw)

    rj = jar.new_resampler(config(jar))
    rt = tar.new_resampler(config(tar, device="cpu"))
    assert [e.dispatch for e in rt._exec] == [e.dispatch for e in rj._exec]
    assert all(e.dispatch == "auto" for e in rt._exec)
    x = list(np.random.default_rng(9).normal(size=(BATCH, 4000)))
    want = np.concatenate([np.stack(rj.process_multi(x)),
                           np.stack(rj.flush_multi())], axis=1)
    got = np.concatenate([np.stack(rt.process_multi(x)),
                          np.stack(rt.flush_multi())], axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_cli_dispatch_tune_on_the_cpu(tmp_path):
    rng = np.random.default_rng(4)
    src = tmp_path / "in.wav"
    w = WavWriter(str(src), 44100, 2, 16)
    w.write((0.3 * rng.standard_normal((6000, 2))).astype(np.float32))
    w.close()
    outs = {}
    for mode in ("tune", "auto"):
        out = tmp_path / f"{mode}.wav"
        assert t_wav.run([str(src), str(out), "-rate", "48000",
                          "-device", "cpu", "-dispatch", mode]) == 0
        outs[mode] = out.read_bytes()
    assert outs["tune"] == outs["auto"] and len(outs["tune"]) > 44


# -- core_fn ------------------------------------------------------------------

CORE_CASES = {
    "rational": lambda: _plans(44100, 48000),
    "decimate": lambda: _plans(48000, 16000),
    "banded": lambda: _composite([(48000, 24000), (48000, 24000)]),
    "fft_decimate": lambda: _plans(96000, 48000),
    "walk": lambda: _plans(44100, 48001),
    "cubic": lambda: _plans(44100, 48000, 0),
    "dft_up": lambda: _plans(48000, 96000),
    "unity": lambda: _plans(48000, 48000),
}


@pytest.mark.parametrize("name", list(CORE_CASES))
def test_core_fn_matches_jax(name, monkeypatch):
    """Both packages' core_fn iterated from _init_state() over the same
    seeded blocks: y[:, :n] and n equal within 1e-12 (the JAX walk returns
    cap-wide y)."""
    if name == "fft_decimate":
        monkeypatch.setattr(streaming, "DECIM_FFT_MIN_TAPS", 0)
        monkeypatch.setattr(joneshot, "DECIM_FFT_MIN_TAPS", 0)
    jp, tp = CORE_CASES[name]()
    je = JEngine(jp, batch=BATCH, block=256, dtype=jnp.float64)
    te = EngineCore(tp, batch=BATCH, block=256, dtype=np.float64,
                    device="cpu")
    assert te.block == je.block
    if name == "fft_decimate":
        assert te._decim_fft is not None and je._decim_fft
    jcore, tcore = je.core_fn(), te.core_fn()
    jst, tst = je._init_state(), te._init_state()
    rng = np.random.default_rng(12)
    total = 0
    for _ in range(4):
        x = rng.normal(size=(BATCH, te.block))
        jst, jy, jn = jcore(jst, jnp.asarray(x))
        tst, ty, tn = tcore(tst, torch.from_numpy(x))
        assert int(tn) == int(jn)
        assert ty.shape[1] >= tn
        np.testing.assert_allclose(ty[:, :tn].numpy(),
                                   np.asarray(jy)[:, :int(jn)], **TOL)
        total += int(tn)
    assert total > 0


def test_core_fn_fixes_the_dispatch_when_called(monkeypatch):
    eng = EngineCore(_cd_dat(), batch=BATCH, block=BLOCK, dtype=np.float64,
                     device="cpu", dispatch="xla")
    core = eng.core_fn()
    eng.dispatch = "pallas"
    seen, real = [], fused.fused_resample
    monkeypatch.setattr(fused, "fused_resample", lambda *a, **kw:
                        seen.append("kernel") or real(*a, **kw))
    x = torch.zeros((BATCH, eng.block), dtype=torch.float64)
    core(eng._init_state(), x)
    assert seen == []
    eng.core_fn()(eng._init_state(), x)
    assert seen == ["kernel"]


# -- set_conv_impl --------------------------------------------------------------

@pytest.fixture
def conv_impls():
    """Both packages' overrides reset after the test (the JAX one is
    process-global, shared with the worker's other test files)."""
    try:
        yield
    finally:
        tconv.set_conv_impl(None)
        jconv.set_conv_impl(None)


CONV_SHAPES = [(1, 8, 1, 40), (4, 17, 3, 200), (2, 33, 2, 517)]


@pytest.mark.parametrize("impl", [None, "xla", "frames", "banded"])
@pytest.mark.parametrize("f,t,stride,n", CONV_SHAPES)
def test_conv_impl_matches_jax(conv_impls, impl, f, t, stride, n):
    rng = np.random.default_rng(f * 1000 + t)
    x = rng.normal(size=(3, n))
    k = rng.normal(size=(f, t))
    tconv.set_conv_impl(impl)
    jconv.set_conv_impl(impl)
    got = tconv.conv1d_poly(torch.from_numpy(x), torch.from_numpy(k), stride)
    want = np.asarray(jconv.conv1d_poly(jnp.asarray(x), jnp.asarray(k),
                                        stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = tconv.conv1d_poly_interleaved(torch.from_numpy(x),
                                        torch.from_numpy(k))
    want = np.asarray(jconv.conv1d_poly_interleaved(jnp.asarray(x),
                                                    jnp.asarray(k)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl,lowering", [
    (None, "_conv_frames"), ("xla", "_conv_xla"),
    ("frames", "_conv_frames"), ("banded", "_conv_banded")])
def test_conv_impl_picks_the_lowering(conv_impls, monkeypatch, impl,
                                      lowering):
    """On CPU tensors: None takes frames (the JAX CPU default), and each
    override its lowering, for both entry points."""
    calls = []
    for name in ("_conv_xla", "_conv_frames", "_conv_banded"):
        real = getattr(tconv, name)
        monkeypatch.setattr(tconv, name, (lambda name, real: lambda *a, **kw:
                                          calls.append(name)
                                          or real(*a, **kw))(name, real))
    tconv.set_conv_impl(impl)
    x, k = torch.randn(2, 100), torch.randn(2, 9)
    tconv.conv1d_poly(x, k, 2)
    tconv.conv1d_poly_interleaved(x, k)
    assert calls == [lowering, lowering]


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_xla_lowering_turns_cudnn_tf32_off(conv_impls, monkeypatch, tier):
    """cuDNN's default TF32 would break the float32 tolerance: the xla
    lowering's F.conv1d calls run with it off, and the setting is back
    after the call."""
    seen, real = [], tconv.F.conv1d
    monkeypatch.setattr(tconv.F, "conv1d", lambda *a, **kw: seen.append(
        torch.backends.cudnn.allow_tf32) or real(*a, **kw))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    tconv.set_conv_impl("xla")
    x, k = torch.randn(2, 300), torch.randn(3, 11)
    y = tconv.conv1d_poly(x, k, 2, tier)
    assert seen and not any(seen)
    assert torch.backends.cudnn.allow_tf32 is True
    tconv.set_conv_impl("frames")
    want = tconv.conv1d_poly(x, k, 2, tier)
    assert torch.allclose(y, want, rtol=0, atol=1e-5 * want.abs().max())


def test_bad_conv_impl_raises_like_jax(conv_impls):
    with pytest.raises(ValueError) as got:
        tconv.set_conv_impl("cudnn")
    with pytest.raises(ValueError) as want:
        jconv.set_conv_impl("cudnn")
    assert str(got.value) == str(want.value) == "unknown conv impl: cudnn"
    assert tconv._IMPL_OVERRIDE is None


def test_conv_impl_reaches_the_engines(conv_impls):
    """The walk's prestage goes through conv1d_poly_interleaved: the
    stream is the same under every lowering (float64, 1e-12)."""
    tp = _plans(44100, 48001)[1]
    x = np.random.default_rng(6).normal(size=(BATCH, 3000))
    outs = {}
    for impl in (None, "xla", "frames", "banded"):
        tconv.set_conv_impl(impl)
        eng = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                         device="cpu")
        outs[impl] = np.concatenate([eng.process(x), eng.flush()], axis=1)
    for impl, y in outs.items():
        assert y.shape == outs[None].shape
        np.testing.assert_allclose(y, outs[None], **TOL)
