"""PyTorch port vs JAX package: the public API (``api.py``, the pipeline
planner) on the CPU.

Both packages get the same ``Config`` (the port's with ``device='cpu'``,
float64 on both sides, as the JAX package computes under x64) and the
same numpy inputs.  Held equal: the planner's stage lists over a grid of
ratios x presets, every stage plan's arrays bit for bit, the execution
chain's kinds and composites, lengths, ``samples_in``/``samples_out``,
``get_latency``, ``estimate_output`` and the errors; outputs of
``process``, ``process_multi``, ``process_into``, ``flush``,
``stream_multi`` and ``process_multi_device`` within 1e-12.  Mirrors the
JAX package's ``tests/test_api.py``, ``test_device_mode.py`` (its public
API cases), ``test_pipeline_fused.py`` (fused against unfused under
``GAR_TPU_FUSE_PIPELINE=0``), ``test_processinto_contract.py`` and
``test_pipeline_multistage.py``.  The card's run is ``chip_smoke.py``'s
phase 12 and ``test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_audio_resampler_tpu as jar
import go_audio_resampler_tpu_torch as tar
from go_audio_resampler_tpu import api as japi
from go_audio_resampler_tpu import pipeline as jpipe
from go_audio_resampler_tpu_torch import api as tapi
from go_audio_resampler_tpu_torch import pipeline as tpipe

TOL = 1e-12
PRESETS = [0, 1, 2, 3, 4]
#: The chains the API builds, by name: (input rate, output rate, preset).
CHAINS = {
    "cd_dat": (44100, 48000, 3),        # one rational stage, K1
    "dat_cd": (48000, 44100, 3),        # strict prefilter composed in
    "96k_44k": (96000, 44100, 3),       # composite with a head
    "48k_8k": (48000, 8000, 3),         # two half-bands + 2/3, fused
    "8k_48k": (8000, 48000, 3),         # up chain, fused
    "48k_16k": (48000, 16000, 3),       # half-band + polyphase, fused
    "44k_3001": (44100, 3001, 4),       # composite, then the walk
    "48k_8000.1": (48000, 8000.1, 3),   # composite, then the walk
    "quick": (44100, 48000, 0),         # cubic
    "identity": (44100, 44100, 3),      # no stage
}
#: Exec kinds each chain must have (both packages).
KINDS = {"cd_dat": ["two_stage"], "dat_cd": ["two_stage"],
         "96k_44k": ["banded"], "48k_8k": ["banded"], "8k_48k": ["banded"],
         "48k_16k": ["banded"], "44k_3001": ["banded", "two_stage"],
         "48k_8000.1": ["banded", "two_stage"], "quick": ["cubic"],
         "identity": []}


def _config(pkg, inr, outr, preset=3, **kw):
    if pkg is tar:
        kw.setdefault("device", "cpu")
    return pkg.Config(inr, outr, quality=pkg.QualitySpec(
        preset=pkg.QualityPreset(preset)), **kw)


_PAIRS: dict = {}


def _pair(name, **kw):
    """(JAX Resampler, port Resampler) of a chain, built once per module
    (``compose`` takes about 1.8 s for the 96k chain in each package) and
    reset on every use."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        inr, outr, q = CHAINS[name]
        _PAIRS[key] = tuple(pkg.new_resampler(_config(pkg, inr, outr, q,
                                                      **kw))
                            for pkg in (jar, tar))
    rj, rt = _PAIRS[key]
    rj.reset()
    rt.reset()
    return rj, rt


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _signal(n, channels=1, seed=0):
    x = np.random.default_rng(seed).normal(size=(channels, n)) * 0.5
    return x[0] if channels == 1 else x


def _cuts(n, seed, k=6):
    return [0] + sorted(int(v) for v in
                        np.random.default_rng(seed).integers(1, n, k)) + [n]


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same_plan(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert vb.dtype == va.dtype and np.array_equal(va, vb), f.name
        elif f.name != "lengths":
            assert va == vb, f.name


# -- planner ---------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_build_pipeline_stage_lists_equal(preset):
    spec = japi.get_preset_spec(preset)
    ratios = [1 / 256, 8000 / 192000, 3001 / 44100, 1 / 6, 0.25, 0.3,
              44100 / 96000, 0.5, 44100 / 48000, 0.9999, 1.0, 1.0005,
              48000 / 44100, 2.0, 2.5, 6.0, 12.0, 256.0]
    for allow in (False, True):
        jq = jpipe.QualityParams(spec.precision, spec.passband_end,
                                 spec.stopband_begin, allow_aliasing=allow)
        tq = tpipe.QualityParams(spec.precision, spec.passband_end,
                                 spec.stopband_begin, allow_aliasing=allow)
        for r in ratios:
            jp, tp = jpipe.build_pipeline(r, jq), tpipe.build_pipeline(r, tq)
            assert [_fields(s) for s in tp.stages] == [_fields(s)
                                                       for s in jp.stages]
            assert (tp.total_ratio, tp.total_latency) == (jp.total_ratio,
                                                          jp.total_latency)
            assert tpipe.optimize_pipeline(tp) is tp
            assert tpipe.should_use_fft(r, tq) == jpipe.should_use_fft(r, jq)
            assert (tpipe.calculate_polyphase_taps(r, tq),
                    tpipe.calculate_cutoff_factor(r, tq),
                    tpipe.calculate_fft_size(r, tq)) == (
                jpipe.calculate_polyphase_taps(r, jq),
                jpipe.calculate_cutoff_factor(r, jq),
                jpipe.calculate_fft_size(r, jq))
        assert (tpipe.calculate_half_band_taps(tq),
                tpipe.calculate_polyphase_phases(tq),
                tpipe.calculate_interpolation_order(tq)) == (
            jpipe.calculate_half_band_taps(jq),
            jpipe.calculate_polyphase_phases(jq),
            jpipe.calculate_interpolation_order(jq))


def test_planner_types_and_errors():
    assert [(s.name, int(s)) for s in tpipe.StageType] == [
        (s.name, int(s)) for s in jpipe.StageType]
    assert tpipe.COMMON_AUDIO_RATIOS == jpipe.COMMON_AUDIO_RATIOS
    q = tpipe.QualityParams(24, 0.95, 0.99)
    for bad in (0.0, -1.0, float("nan")):
        with pytest.raises(tpipe.PipelineError, match="invalid ratio"):
            tpipe.build_pipeline(bad, q)


# -- configuration, presets, errors -------------------------------------------

@pytest.mark.parametrize("preset", PRESETS + [5])
def test_presets_equal(preset):
    assert _fields(tapi.get_preset_spec(preset)) == _fields(
        japi.get_preset_spec(preset))


def test_precision_to_engine_quality_equal():
    for bits in range(1, 40):
        assert int(tapi.precision_to_engine_quality(bits)) == int(
            japi.precision_to_engine_quality(bits))
    assert [(q.name, int(q)) for q in tapi.QualityFlags] == [
        (q.name, int(q)) for q in japi.QualityFlags]
    assert (tapi.MAX_CHANNELS, tapi.ESTIMATE_OUTPUT_MARGIN,
            tapi.STEREO_CHANNELS) == (japi.MAX_CHANNELS,
                                      japi.ESTIMATE_OUTPUT_MARGIN,
                                      japi.STEREO_CHANNELS)


@pytest.mark.parametrize("args,kw", [
    ((0, 48000), {}), ((48000, 0), {}), ((-1, 48000), {}),
    ((float("nan"), 48000), {}), ((48000, float("inf")), {}),
    ((44100, 48000), {"channels": 0}), ((44100, 48000), {"channels": 257}),
    ((48000, 48000 / 300), {}), ((44100, 48000), {"dispatch": "fast"}),
    ((44100, 48000), {"precision": "fast"}),
    ((44100, 48000), {"quality": "custom5"}),
    ((44100, 48000), {"quality": "custom_band"}),
])
def test_config_errors_equal(args, kw):
    def make(pkg):
        k = dict(kw)
        if k.get("quality") == "custom5":
            k["quality"] = pkg.QualitySpec(preset=pkg.QualityPreset.CUSTOM,
                                           precision=5)
        elif k.get("quality") == "custom_band":
            k["quality"] = pkg.QualitySpec(
                preset=pkg.QualityPreset.CUSTOM, precision=20,
                passband_end=0.9, stopband_begin=0.8)
        return pkg.Config(*args, **k)

    with pytest.raises(japi.InvalidConfigError) as jerr:
        jar.new_resampler(make(jar))
    with pytest.raises(tapi.InvalidConfigError) as terr:
        tar.new_resampler(make(tar))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(tapi.InvalidConfigError, match="None"):
        tar.new_resampler(None)


def test_config_device_and_dtype():
    assert tapi.default_dtype("cpu") == np.float64
    assert tapi.default_dtype("cuda") == np.float32
    assert tapi.Config(44100, 48000).device == "cuda"
    with pytest.raises(tapi.InvalidConfigError, match="device"):
        tapi.Config(44100, 48000, device="nonsense").validate()
    r = tar.new_resampler(_config(tar, 44100, 48000, dtype=np.float32))
    assert r.dtype == np.float32 and r._exec[0].dtype == torch.float32
    assert r.process(np.zeros(4000)).dtype == np.float32
    assert r.get_info().simd_type == "torch:cpu"


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is valid")
    for cfg in (tapi.Config(44100, 48000), tapi.Config(44100, 44100)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tar.new_resampler(cfg)


def test_dispatch_tune_reaches_the_engines():
    """Config(dispatch='tune') builds every engine with the tune, which
    resolves to 'auto' off the card; the output is the 'auto' config's."""
    r = tar.new_resampler(_config(tar, 44100, 48000, dispatch="tune",
                                  channels=2))
    assert r._exec and all(e.dispatch == "auto" for e in r._exec)
    ref = tar.new_resampler(_config(tar, 44100, 48000, channels=2))
    x = list(np.random.default_rng(3).normal(size=(2, 5000)))
    got = np.concatenate([np.stack(r.process_multi(x)),
                          np.stack(r.flush_multi())], axis=1)
    want = np.concatenate([np.stack(ref.process_multi(x)),
                           np.stack(ref.flush_multi())], axis=1)
    assert got.shape == want.shape and got.shape[1] > 0
    assert np.array_equal(got, want)


# -- the chain: stage plans, exec kinds, composites ------------------------------

@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_structure_equal(name):
    rj, rt = _pair(name)
    assert [_fields(s) for s in rt.pipeline.stages] == [
        _fields(s) for s in rj.pipeline.stages]
    assert [type(e).__name__ for e in rt._engines] == [
        type(e).__name__ for e in rj._engines]
    for ej, et in zip(rj._engines, rt._engines):
        _same_plan(ej.plan, et.plan)
        assert (et.block, et.get_latency()) == (ej.block, ej.get_latency())
    kinds = [getattr(e.plan, "kind", "?") for e in rt._exec]
    assert kinds == [getattr(e.plan, "kind", "?") for e in rj._exec]
    assert kinds == KINDS[name]
    assert (rt._fused is None) == (rj._fused is None)
    for ej, et in zip(rj._exec, rt._exec):
        if et.plan.kind == "banded":
            oj, ot = ej.plan.op, et.plan.op
            assert (ot.P, ot.I, ot.W, ot.lam) == (oj.P, oj.I, oj.W, oj.lam)
            assert np.array_equal(ot.R, oj.R)
            if ot.head is None or oj.head is None:
                assert all(h is None or h.shape[0] == 0
                           for h in (ot.head, oj.head))
            else:
                assert np.array_equal(ot.head, oj.head)
            assert et.plan.fingerprint[:6] == ej.plan.fingerprint[:6]
        assert (et.block, et.get_latency()) == (ej.block, ej.get_latency())
    assert rt.device_chunk_multiple == rj.device_chunk_multiple
    assert (rt.get_latency(), rt.get_ratio(), rt.dtype) == (
        rj.get_latency(), rj.get_ratio(), rj.dtype)
    for n in (0, 1, 1000, 44100):
        assert rt.estimate_output(n) == rj.estimate_output(n)
    ij, it = _fields(rj.get_info()), _fields(rt.get_info())
    assert it.pop("simd_type") == "torch:cpu" and ij.pop("simd_type")
    assert it == ij


# -- outputs ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CHAINS))
def test_process_flush_equal(name):
    """The mono path in random chunks, then flush."""
    rj, rt = _pair(name)
    inr = CHAINS[name][0]
    n = min(inr // 2, 24000)
    x = _signal(n, seed=1)
    cuts = _cuts(n, 2)
    outs = []
    for r in (rj, rt):
        ys = [np.asarray(r.process(x[a:b])) for a, b in zip(cuts[:-1],
                                                             cuts[1:])]
        ys.append(np.asarray(r.flush()))
        outs.append(np.concatenate(ys))
    assert outs[1].dtype == np.float64
    _close(outs[1], outs[0])
    assert rt.get_statistics() == rj.get_statistics()
    assert rt.samples_in == n


@pytest.mark.parametrize("name", ["cd_dat", "96k_44k", "48k_8k",
                                  "44k_3001"])
def test_process_multi_equal(name):
    rj, rt = _pair(name, channels=3)
    x = _signal(6000, channels=3, seed=3)
    outs = []
    for r in (rj, rt):
        a = np.stack(r.process_multi(list(x[:, :2500])))
        b = np.stack(r.process_multi(list(x[:, 2500:])))
        t = np.stack(r.flush_multi())
        outs.append(np.concatenate([a, b, t], axis=1))
    _close(outs[1], outs[0])
    assert rt.get_statistics() == rj.get_statistics()


@pytest.mark.parametrize("name", ["cd_dat", "48k_8k", "quick"])
def test_process_into_equal(name):
    """``process_into`` and ``process_float32_into``: the same counts, the
    same samples, BufferTooSmallError before any state advances."""
    rj, rt = _pair(name)
    x = _signal(3000, seed=4)
    got = []
    for r, err in ((rj, japi.BufferTooSmallError),
                   (rt, tapi.BufferTooSmallError)):
        with pytest.raises(err):
            r.process_into(x[:1000], np.zeros(10))
        assert r.get_statistics()["samplesIn"] == 0
        ys = []
        for a in range(0, 3000, 700):
            out = np.zeros(r.estimate_output(len(x[a:a + 700])))
            k = r.process_into(x[a:a + 700], out)
            ys.append(out[:k].copy())
        ys.append(np.asarray(r.flush()))
        got.append(np.concatenate(ys))
        r.reset()
        out32 = np.zeros(r.estimate_output(3000), np.float32)
        k = r.process_float32_into(x.astype(np.float32), out32)
        got.append(out32[:k].copy())
    _close(got[2], got[0])
    _close(got[3], got[1])
    assert got[3].dtype == np.float32


def test_process_float32_equal():
    rj, rt = _pair("cd_dat")
    x = _signal(2000, seed=5).astype(np.float32)
    yj, yt = rj.process_float32(x), rt.process_float32(x)
    assert yt.dtype == np.float32
    _close(yt, yj)


@pytest.mark.parametrize("name", ["cd_dat", "96k_44k", "48k_16k",
                                  "44k_3001"])
def test_stream_multi_equal(name):
    """``stream_multi(out='host')``: the fused chains through the engine's
    pipelined stream, the others through process_multi/flush_multi."""
    rj, rt = _pair(name, channels=2)
    x = _signal(9000, channels=2, seed=6)
    chunks = [x[:, :1234], x[:, 1234:5000], x[:, 5000:]]
    yj = np.concatenate(list(rj.stream_multi(iter(chunks))), axis=1)
    yt = np.concatenate(list(rt.stream_multi(iter(chunks))), axis=1)
    _close(yt, yj)
    assert rt.get_statistics() == rj.get_statistics()
    with pytest.raises(tapi.ResamplerError, match="flushed"):
        rt.process_multi(list(x[:, :10]))


@pytest.mark.parametrize("name", ["cd_dat", "96k_44k", "48k_8k"])
def test_process_multi_device_equal(name):
    """The device mode, against the JAX package's and against the host
    mode; on the CPU its tensors stay on the CPU."""
    rj, rt = _pair(name, channels=2)
    mult = rt.device_chunk_multiple
    assert mult == rj.device_chunk_multiple and mult
    x = _signal(5 * mult, channels=2, seed=7)
    yj = np.concatenate([np.asarray(rj.process_multi_device(
        jnp.asarray(x[:, :3 * mult]))), np.asarray(rj.process_multi_device(
            jnp.asarray(x[:, 3 * mult:]))), np.asarray(
        rj.flush_multi_device())], axis=1)
    y1 = rt.process_multi_device(x[:, :3 * mult])
    y2 = rt.process_multi_device(torch.from_numpy(x[:, 3 * mult:]))
    y3 = rt.flush_multi_device()
    assert all(isinstance(y, torch.Tensor) and y.device.type == "cpu"
               for y in (y1, y2, y3))
    yt = torch.cat([y1, y2, y3], dim=1).numpy()
    _close(yt, yj)
    assert rt.get_statistics() == rj.get_statistics()
    assert rt.flush_multi_device().shape == (2, 0)
    rt.reset()
    host = np.concatenate([np.stack(rt.process_multi(list(x))),
                           np.stack(rt.flush_multi())], axis=1)
    _close(yt, host)


def test_device_mode_guards():
    """The JAX package's guards and messages: unfusable chains, queued
    host output, bad shapes, flush twice, process after flush."""
    rj, rt = _pair("44k_3001", channels=2)
    for r, mod in ((rj, japi), (rt, tapi)):
        assert r.device_chunk_multiple is None
        with pytest.raises(NotImplementedError, match="segment"):
            r.process_multi_device(np.zeros((2, 1024)))
        with pytest.raises(NotImplementedError):
            r.flush_multi_device()
        with pytest.raises(NotImplementedError, match="segment"):
            r.stream_multi([], out="device")
        assert r._entry_mode is None
    _, rt = _pair("cd_dat", channels=2)
    mult = rt.device_chunk_multiple
    rt._out_queue = np.zeros((2, 5), dtype=rt.dtype)
    with pytest.raises(tapi.ResamplerError, match="queued"):
        rt.process_multi_device(np.zeros((2, mult)))
    with pytest.raises(tapi.ResamplerError, match="queued"):
        rt.flush_multi_device()
    with pytest.raises(tapi.ResamplerError, match="queued"):
        rt.stream_multi([])
    rt.reset()
    with pytest.raises(tapi.InvalidConfigError, match="channels"):
        rt.process_multi_device(np.zeros((3, mult)))
    with pytest.raises(ValueError, match="out must be"):
        rt.stream_multi([], out="disk")
    rt.process_multi_device(np.zeros((2, 2 * mult)))
    rt.flush_multi_device()
    assert rt.flush_multi_device().shape == (2, 0)
    with pytest.raises(tapi.ResamplerError, match="flush"):
        rt.process_multi_device(np.zeros((2, mult)))


def test_stream_multi_device_out():
    _, rt = _pair("48k_16k", channels=2)
    x = _signal(8000, channels=2, seed=8)
    ys = list(rt.stream_multi([x[:, :3000], x[:, 3000:]], out="device"))
    assert all(isinstance(y, torch.Tensor) for y in ys)
    got = torch.cat(ys, dim=1).numpy()
    rt.reset()
    want = np.concatenate([np.stack(rt.process_multi(list(x))),
                           np.stack(rt.flush_multi())], axis=1)
    _close(got, want)


# -- fusion ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["96k_44k", "48k_8k", "44k_3001"])
def test_unfused_chain_equal(name, monkeypatch):
    """Under GAR_TPU_FUSE_PIPELINE=0 both packages run the per-stage chain
    (read when the Resampler is built): equal to each other within 1e-12,
    and to the port's fused chain within 1e-9 (test_pipeline_fused.py's
    bound)."""
    inr, outr, q = CHAINS[name]
    monkeypatch.setenv("GAR_TPU_FUSE_PIPELINE", "0")
    rj = jar.new_resampler(_config(jar, inr, outr, q))
    rt = tar.new_resampler(_config(tar, inr, outr, q))
    monkeypatch.delenv("GAR_TPU_FUSE_PIPELINE")
    assert rt._exec is rt._engines and rt._fused is None
    assert len(rt._exec) == len(rj._exec) == len(rt.pipeline.stages)
    x = _signal(9000, seed=9)
    yj = np.concatenate([rj.process(x), rj.flush()])
    yt = np.concatenate([rt.process(x), rt.flush()])
    _close(yt, yj)
    _, rf = _pair(name)
    yf = np.concatenate([rf.process(x), rf.flush()])
    _close(yf, yt, 1e-9)


def test_strict_and_flags():
    """Strict antialias: auto at HIGH for a non-integer downsample, off
    with ALLOW_ALIASING, forced by strict_antialias=True; as in JAX."""
    for kw in ({}, {"strict_antialias": False}, {"strict_antialias": True}):
        for flags in (0, 8):
            plans = []
            for pkg in (jar, tar):
                cfg = _config(pkg, 48000, 44100, 3, **kw)
                cfg.quality.flags = pkg.QualityFlags(flags)
                r = pkg.new_resampler(cfg)
                plans.append(r._engines[0].plan.aa_taps)
            assert plans[0] == plans[1]
    assert plans[1] > 0


# -- contracts --------------------------------------------------------------------

def test_stub_engine_equal():
    x = np.arange(20, dtype=np.float64).reshape(2, 10)
    sj = japi.StubEngine(1.5, batch=2, dtype=np.float64)
    st = tapi.StubEngine(1.5, batch=2, dtype=np.float64)
    assert np.array_equal(st.process(x), sj.process(x))
    assert st.flush().shape == sj.flush().shape == (2, 0)
    assert (st.get_latency(), st.get_ratio(), st.estimate_output(7)) == (
        sj.get_latency(), sj.get_ratio(), sj.estimate_output(7))
    assert st.get_statistics() == sj.get_statistics() == {
        "samplesIn": 10, "samplesOut": 15}
    st.reset()
    assert st.get_statistics() == {"samplesIn": 0, "samplesOut": 0}
    assert st.process(np.zeros((2, 0))).shape == (2, 0)


def test_stage_engine_falls_back_to_stub(monkeypatch):
    """A stage whose plan cannot be built becomes a StubEngine in both
    packages (stages.go:36-43)."""
    spec = tpipe.StageSpec(type=tpipe.StageType.POLYPHASE, ratio=1.5,
                           quality=24)

    def fail(*a, **k):
        raise ValueError("no plan")

    monkeypatch.setattr(tapi, "plan_engine", fail)
    eng = tapi._stage_engine(spec, 2, 1024, np.float64, device="cpu")
    assert isinstance(eng, tapi.StubEngine) and eng.get_ratio() == 1.5
    monkeypatch.setattr(japi, "plan_engine", fail)
    jeng = japi._stage_engine(jpipe.StageSpec(
        type=jpipe.StageType.POLYPHASE, ratio=1.5, quality=24), 2, 1024,
        np.float64)
    assert type(jeng).__name__ == type(eng).__name__


def test_mixed_mono_multi_rejected():
    _, rt = _pair("cd_dat", channels=2)
    x = _signal(500, seed=10)
    rt.process_multi([x, x])
    with pytest.raises(tapi.ResamplerError, match="cannot mix"):
        rt.process(x)
    rt.reset()
    rt.process(x)
    with pytest.raises(tapi.ResamplerError, match="cannot mix"):
        rt.process_multi([x, x])
    with pytest.raises(tapi.InvalidConfigError, match="equal length"):
        _pair("cd_dat", channels=2)[1].process_multi([x, x[:5]])
    with pytest.raises(tapi.InvalidConfigError, match="expected 2"):
        rt.reset() or rt.process_multi([x])
    rt.reset()
    with pytest.raises(tapi.InvalidConfigError, match="1-D"):
        rt.process(np.zeros((2, 5)))


def test_reset_reproducible_and_flush_once():
    _, rt = _pair("44k_3001")
    x = _signal(8000, seed=11)
    a = np.concatenate([rt.process(x), rt.flush()])
    with pytest.raises(tapi.ResamplerError, match="flushed"):
        rt.process(x)
    rt.reset()
    b = np.concatenate([rt.process(x), rt.flush()])
    assert np.array_equal(a, b)


def test_short_input_all_output_via_flush():
    """Input shorter than the chain's latency surfaces through flush
    (the reference's front-to-back tail propagation), as in JAX."""
    rj, rt = _pair("48k_8k")
    x = np.sin(2 * np.pi * 500 / 48000 * np.arange(2000))
    yj = np.concatenate([rj.process(x), rj.flush()])
    yt = np.concatenate([rt.process(x), rt.flush()])
    _close(yt, yj)
    assert np.abs(yt).max() > 0.8


def test_identity_chain():
    rj, rt = _pair("identity", channels=2)
    x = _signal(1000, channels=2, seed=12)
    yt = np.stack(rt.process_multi(list(x)))
    assert np.array_equal(yt, np.stack(rj.process_multi(list(x))))
    assert np.array_equal(yt, x)
    assert rt.flush_multi()[0].shape == (0,)
    assert rt.get_info().algorithm == "identity"


def test_get_info_of_other_objects():
    class Bare:
        def get_latency(self):
            return 7

    assert dataclasses.asdict(tapi.get_info(Bare())) == dataclasses.asdict(
        japi.get_info(Bare()))


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port, and not ``chip_smoke.py``, imports JAX or
    the JAX package (read from their sources, so that modules imported
    only inside functions count too)."""
    import ast
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root,
                                            "go_audio_resampler_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert any(f.endswith("convenience.py") for f in files)
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib",
                                   "go_audio_resampler_tpu"), (path, m)
