"""PyTorch port vs JAX package: stream checkpoint and resume
(``engine/checkpoint.py``).

The port runs on ``device='cpu'`` in float64 beside the JAX package on
the CPU.  For every topology a checkpoint covers (exact rational,
decimation, cubic, dft_up, the general walk, the strict-antialias exact
plan and walk, a banded composite with and without head rows, the FFT
decimation step):

- the plan fingerprints, the state leaves' shapes and dtypes, and after
  the same input the integer leaves, are equal in both packages;
- a port snapshot taken mid-stream resumes in a fresh port engine bit for
  bit equal to the uninterrupted run;
- files cross in both directions: a JAX-written file and a port-written
  one at the same point have the same keys, shapes and dtypes, equal
  integer arrays, and each loads into the other package, whose
  continuation lies within 1e-12 of the writer's uninterrupted run.

The cases of ``tests/test_checkpoint_public.py`` and the checkpoint cases
of ``tests/test_streaming_extras.py`` are carried over to the port: the
composite resumed inside its head region, the public ``Resampler``, the
variable-rate resampler mid-slew, and the rejections (fingerprint, shape,
dtype, magic, stub segment, a legacy file in the head region).
"""

import dataclasses
import functools
import importlib

import jax
import numpy as np
import pytest

import go_audio_resampler_tpu as jar
import go_audio_resampler_tpu_torch as tar
from go_audio_resampler_tpu.engine import checkpoint as jck
from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.engine.streaming import EngineCore as JEngine
from go_audio_resampler_tpu.engine.variable import \
    VariableRateResampler as JVR
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu.pipeline import fused as jfused
from go_audio_resampler_tpu_torch.engine import (
    EngineCore, VariableRateResampler, load_resampler_state,
    load_stream_state, load_vr_state, plan_engine, save_resampler_state,
    save_stream_state, save_vr_state)
from go_audio_resampler_tpu_torch.engine.checkpoint import (_host,
                                                            _leaf_spec,
                                                            _state_leaves)
from go_audio_resampler_tpu_torch.filterdesign import Quality
from go_audio_resampler_tpu_torch.pipeline import fused as tfused
from go_audio_resampler_tpu_torch.utils import signals

jon = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
tstreaming = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.streaming")

TOL = 1e-12
BATCH, BLOCK, N, CUT = 2, 512, 4000, 1700
RNG = np.random.default_rng(11)


def _plans(a, b, q=3, aa=False):
    return (jplan_engine(float(a), float(b), JQuality(q), aa),
            plan_engine(float(a), float(b), Quality(q), aa))


def _banded(stages, ratio):
    jop = jfused.fuse_chain([jplan_engine(float(a), float(b), JQuality(3), s)
                             for a, b, s in stages])
    top = tfused.fuse_chain([plan_engine(float(a), float(b), Quality(3), s)
                             for a, b, s in stages])
    return jfused.BandedPlan(jop, ratio), tfused.BandedPlan(top, ratio)


#: topology -> (JAX plan, port plan) builder
TOPOLOGIES = {
    "rational": lambda: _plans(44100, 48000),
    "decimate": lambda: _plans(48000, 16000),
    "cubic": lambda: _plans(44100, 48000, 0),
    "dft_up": lambda: _plans(48000, 96000),
    "walk": lambda: _plans(44100, 48001),
    "strict_exact": lambda: _plans(48000, 44100, 3, True),
    "strict_walk": lambda: _plans(48000, 44099, 3, True),
    "composite_head": lambda: _banded(
        [(48000, 24000, False), (24000, 22050, True)], 22050 / 48000),
    "composite_free": lambda: _banded(
        [(48000, 24000, False), (48000, 24000, False)], 0.25),
    "fft_decim": lambda: _plans(96000, 48000, 4),
}


@pytest.fixture
def topology(request, monkeypatch):
    """(name, JAX plan, port plan); the FFT decimation step is reached by
    lowering DECIM_FFT_MIN_TAPS in both packages for the test."""
    name = request.param
    if name == "fft_decim":
        monkeypatch.setattr(jon, "DECIM_FFT_MIN_TAPS", 0)
        monkeypatch.setattr(tstreaming, "DECIM_FFT_MIN_TAPS", 0)
    return (name,) + _topology_plans(name)


@functools.lru_cache(maxsize=None)
def _topology_plans(name):
    return TOPOLOGIES[name]()


def _engines(jp, tp):
    return (JEngine(jp, batch=BATCH, block=BLOCK, dtype=np.float64),
            EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                       device="cpu"))


def _input(seed=0):
    return np.random.default_rng(seed).standard_normal((BATCH, N)) * 0.5


def _run(eng, x):
    return np.concatenate([eng.process(x), eng.flush()], axis=1)


def _run_split(eng, x):
    """The uninterrupted run, fed in the two chunks a resumed run gets
    (the FFT decimation step's rounding follows its steps' starts)."""
    return np.concatenate([eng.process(x[:, :CUT]), _run(eng, x[:, CUT:])],
                          axis=1)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _payload(path) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


PARAMS = pytest.mark.parametrize("topology", list(TOPOLOGIES),
                                 indirect=True)


@PARAMS
def test_state_matches_jax(topology):
    """Fingerprints, the state leaves' shapes and dtypes in the JAX
    package's flatten order, and after the same input the integer leaves
    and counters, are equal in both packages."""
    _name, jp, tp = topology
    assert repr(jp.fingerprint) == repr(tp.fingerprint)
    ej, et = _engines(jp, tp)
    for _ in range(2):
        jl, _ = jax.tree_util.tree_flatten(ej.state)
        tl = _state_leaves(et.state)
        assert ([(np.shape(l), np.asarray(l).dtype) for l in jl]
                == [_leaf_spec(l) for l in tl])
        for a, b in zip(jl, tl):
            if np.ndim(a) == 0:
                assert int(np.asarray(a)) == int(_host(b))
        assert ((ej.samples_in, ej.samples_out, ej._core_emitted)
                == (et.samples_in, et.samples_out, et._core_emitted))
        x = _input()[:, :CUT]
        ej.process(x)
        et.process(x)


@PARAMS
def test_port_resume_bit_identical(topology, tmp_path):
    _name, _jp, tp = topology
    x = _input(1)
    full = _run_split(EngineCore(tp, batch=BATCH, block=BLOCK,
                                 dtype=np.float64, device="cpu"), x)
    a = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                   device="cpu")
    part1 = a.process(x[:, :CUT])
    save_stream_state(a, tmp_path / "s.npz")
    b = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                   device="cpu")
    load_stream_state(b, tmp_path / "s.npz")
    resumed = np.concatenate([part1, _run(b, x[:, CUT:])], axis=1)
    np.testing.assert_array_equal(resumed, full)


@PARAMS
def test_files_cross_both_ways(topology, tmp_path):
    """Both packages write the same file at the same point (keys, shapes,
    dtypes; integer arrays equal), and each loads the other's: the
    continuation lies within 1e-12 of the writer's uninterrupted run."""
    _name, jp, tp = topology
    x = _input(2)
    ej, et = _engines(jp, tp)
    full_j = _run_split(ej, x)
    full_t = _run_split(et, x)
    _close(full_t, full_j)
    ej.reset()
    et.reset()
    part_j = ej.process(x[:, :CUT])
    part_t = et.process(x[:, :CUT])
    jck.save_stream_state(ej, tmp_path / "j.npz")
    save_stream_state(et, tmp_path / "t.npz")
    fj, ft = _payload(tmp_path / "j.npz"), _payload(tmp_path / "t.npz")
    assert fj.keys() == ft.keys()
    for k in fj:
        assert (fj[k].shape, fj[k].dtype) == (ft[k].shape, ft[k].dtype), k
        if fj[k].dtype.kind in "iu" or k == "plan_fp":
            np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)
    # JAX file -> port engine, port file -> JAX engine.
    et2 = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                     device="cpu")
    load_stream_state(et2, tmp_path / "j.npz")
    _close(np.concatenate([part_j, _run(et2, x[:, CUT:])], axis=1), full_j)
    ej2 = JEngine(jp, batch=BATCH, block=BLOCK, dtype=np.float64)
    jck.load_stream_state(ej2, tmp_path / "t.npz")
    _close(np.concatenate([part_t, _run(ej2, x[:, CUT:])], axis=1), full_t)


# -- carried over: tests/test_streaming_extras.py TestCheckpointResume --------

def _rational_engine(**kw):
    kw.setdefault("batch", 1)
    kw.setdefault("dtype", np.float64)
    return EngineCore(plan_engine(44100, 48000, Quality.HIGH), block=512,
                      device="cpu", **kw)


def test_resume_bit_identical(tmp_path):
    x = signals.sine(6000, 997.0, 44100)
    eng = _rational_engine()
    full = np.concatenate([eng.process(x)[0], eng.flush()[0]])
    eng_a = _rational_engine()
    part1 = eng_a.process(x[:3000])[0]
    save_stream_state(eng_a, tmp_path / "stream.npz")
    eng_b = _rational_engine()
    load_stream_state(eng_b, tmp_path / "stream.npz")
    resumed = np.concatenate([part1, eng_b.process(x[3000:])[0],
                              eng_b.flush()[0]])
    np.testing.assert_array_equal(resumed, full)


def test_resume_portable_across_dispatch_pins(tmp_path):
    """A stream saved from a dispatch='xla' engine resumes bit for bit on
    an 'auto' engine: the state is samples and counters."""
    x = signals.sine(6000, 997.0, 44100)
    full = np.concatenate([(e := _rational_engine()).process(x)[0],
                           e.flush()[0]])
    eng_a = _rational_engine(dispatch="xla")
    part1 = eng_a.process(x[:3000])[0]
    save_stream_state(eng_a, tmp_path / "stream_xla.npz")
    eng_b = _rational_engine(dispatch="auto")
    load_stream_state(eng_b, tmp_path / "stream_xla.npz")
    resumed = np.concatenate([part1, eng_b.process(x[3000:])[0],
                              eng_b.flush()[0]])
    np.testing.assert_array_equal(resumed, full)


def test_shape_mismatch_rejected(tmp_path):
    save_stream_state(_rational_engine(), tmp_path / "s.npz")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_stream_state(_rational_engine(batch=2), tmp_path / "s.npz")


def test_bad_file_rejected(tmp_path):
    np.savez(tmp_path / "junk.npz", magic=np.zeros(3, np.uint8))
    with pytest.raises((ValueError, KeyError)):
        load_stream_state(_rational_engine(), tmp_path / "junk.npz")
    save_vr_state(VariableRateResampler(2.0, device="cpu"),
                  tmp_path / "vr.npz")
    with pytest.raises(ValueError, match="not a stream state file"):
        load_stream_state(_rational_engine(), tmp_path / "vr.npz")


def test_dtype_mismatch_rejected(tmp_path):
    save_stream_state(_rational_engine(dtype=np.float32), tmp_path / "f.npz")
    with pytest.raises(ValueError, match="dtype"):
        load_stream_state(_rational_engine(), tmp_path / "f.npz")


# -- carried over: tests/test_checkpoint_public.py ----------------------------

def _banded_head_plan():
    op = tfused.fuse_chain([plan_engine(48000.0, 24000.0, Quality.HIGH),
                            plan_engine(24000.0, 22050.0, Quality.HIGH,
                                        True)])
    assert op is not None and op.n_head > 0
    return tfused.BandedPlan(op, ratio=22050.0 / 48000.0)


def _head_engine(plan):
    return EngineCore(plan, batch=1, block=512, dtype=np.float64,
                      device="cpu")


def test_resume_mid_head_bit_identical(tmp_path):
    """A snapshot taken before the aperiodic head drains resumes with the
    exact head rows (the file holds the input prefix)."""
    plan = _banded_head_plan()
    x = RNG.standard_normal((1, 20000))
    full = _run(_head_engine(plan), x)
    eng_a = _head_engine(plan)
    part1 = eng_a.process(x[:, :1024])
    assert eng_a.samples_out < plan.op.n_head and eng_a._head_have > 0
    save_stream_state(eng_a, tmp_path / "mid_head.npz")
    eng_b = _head_engine(plan)
    load_stream_state(eng_b, tmp_path / "mid_head.npz")
    resumed = np.concatenate([part1, _run(eng_b, x[:, 1024:])], axis=1)
    np.testing.assert_array_equal(resumed, full)


def test_legacy_snapshot_without_head_rejected_in_head_region(tmp_path):
    plan = _banded_head_plan()
    eng = _head_engine(plan)
    eng.process(RNG.standard_normal((1, 1024)))
    assert eng.samples_out < plan.op.n_head
    save_stream_state(eng, tmp_path / "full.npz")
    stripped = {k: v for k, v in _payload(tmp_path / "full.npz").items()
                if k != "head_x"}
    np.savez(tmp_path / "legacy.npz", **stripped)
    with pytest.raises(ValueError, match="head"):
        load_stream_state(_head_engine(plan), tmp_path / "legacy.npz")


def test_cross_config_restore_rejected(tmp_path):
    save_stream_state(_rational_engine(), tmp_path / "a.npz")
    other = EngineCore(plan_engine(44100.0, 48000.0, Quality.VERY_HIGH),
                       batch=1, block=512, dtype=np.float64, device="cpu")
    with pytest.raises(ValueError):
        load_stream_state(other, tmp_path / "a.npz")


def test_same_geometry_different_coeffs_rejected(tmp_path):
    """BandedPlan.fingerprint hashes the coefficients: composites of the
    same geometry but other filters may not exchange checkpoints."""
    plan = _banded_head_plan()
    eng = _head_engine(plan)
    eng.process(RNG.standard_normal((1, 4096)))
    save_stream_state(eng, tmp_path / "banded.npz")
    op2 = dataclasses.replace(plan.op, R=plan.op.R * (1.0 + 1e-6))
    plan2 = tfused.BandedPlan(op2, ratio=plan.ratio)
    assert plan2.fingerprint != plan.fingerprint
    with pytest.raises(ValueError, match="fingerprint"):
        load_stream_state(_head_engine(plan2), tmp_path / "banded.npz")


def _mk_resampler(pkg=tar, channels=1, dtype=np.float64):
    kw = {"device": "cpu"} if pkg is tar else {}
    return pkg.new_resampler(pkg.Config(
        48000, 8000, channels=channels,
        quality=pkg.QualitySpec(preset=pkg.QualityPreset.HIGH),
        dtype=dtype, **kw))


def test_resampler_mono_resume_bit_identical(tmp_path):
    x = signals.sine(30000, 440.0, 48000.0)
    r_full = _mk_resampler()
    full = np.concatenate([r_full.process(x), r_full.flush()])
    r_a = _mk_resampler()
    assert r_a._fused is not None     # the default fused path
    part1 = r_a.process(x[:13000])
    save_resampler_state(r_a, tmp_path / "resampler.npz")
    r_b = _mk_resampler()
    load_resampler_state(r_b, tmp_path / "resampler.npz")
    resumed = np.concatenate([part1, r_b.process(x[13000:]), r_b.flush()])
    np.testing.assert_array_equal(resumed, full)


def test_resampler_multichannel_resume_bit_identical(tmp_path):
    chans = [signals.sine(24000, f, 48000.0) for f in (300.0, 700.0)]
    r_full = _mk_resampler(channels=2)
    full = [np.concatenate([o, t]) for o, t in
            zip(r_full.process_multi(chans), r_full.flush_multi())]
    r_a = _mk_resampler(channels=2)
    p1 = r_a.process_multi([c[:9000] for c in chans])
    save_resampler_state(r_a, tmp_path / "multi.npz")
    r_b = _mk_resampler(channels=2)
    load_resampler_state(r_b, tmp_path / "multi.npz")
    p2 = r_b.process_multi([c[9000:] for c in chans])
    p3 = r_b.flush_multi()
    for i in range(2):
        np.testing.assert_array_equal(np.concatenate([p1[i], p2[i], p3[i]]),
                                      full[i])


def test_resampler_entry_mode_and_queue_survive(tmp_path):
    """The wrapper's own state (entry-mode guard, output queue) is part of
    the snapshot, not just the engines'."""
    chans = [signals.sine(6000, 500.0, 48000.0)] * 2
    r_a = _mk_resampler(channels=2)
    r_a.process_multi(chans)
    save_resampler_state(r_a, tmp_path / "mode.npz")
    r_b = _mk_resampler(channels=2)
    load_resampler_state(r_b, tmp_path / "mode.npz")
    assert r_b._entry_mode == 'multi'
    with pytest.raises(tar.ResamplerError, match="mix"):
        r_b.process(chans[0])
    # A near-block backlog, then a process_into whose release exceeds its
    # own estimate_output limit: the surplus is queued.
    r_c = _mk_resampler()
    blk = r_c._fused.block
    r_c.process(signals.sine(2 * blk, 500.0, 48000.0))
    r_c.process(np.zeros(blk - 6))
    n2 = blk + 12
    x2 = signals.sine(n2, 500.0, 48000.0)
    r_c.process_into(x2, np.zeros(r_c.estimate_output(n2)))
    assert r_c._out_queue.shape[1] > 0
    save_resampler_state(r_c, tmp_path / "queue.npz")
    r_d = _mk_resampler()
    load_resampler_state(r_d, tmp_path / "queue.npz")
    np.testing.assert_array_equal(r_d._out_queue, r_c._out_queue)
    a = np.concatenate([r_c.process(x2), r_c.flush()])
    b = np.concatenate([r_d.process(x2), r_d.flush()])
    np.testing.assert_array_equal(a, b)


def test_resampler_flushed_flag_survives(tmp_path):
    r = _mk_resampler()
    r.process(signals.sine(6000, 500.0, 48000.0))
    r.flush()
    save_resampler_state(r, tmp_path / "flushed.npz")
    r2 = _mk_resampler()
    load_resampler_state(r2, tmp_path / "flushed.npz")
    with pytest.raises(tar.ResamplerError):
        r2.process(np.zeros(100))


def test_resampler_config_mismatch_rejected(tmp_path):
    r = _mk_resampler()
    save_resampler_state(r, tmp_path / "cfg.npz")
    with pytest.raises(ValueError, match="channel"):
        load_resampler_state(_mk_resampler(channels=2), tmp_path / "cfg.npz")
    with pytest.raises(ValueError, match="dtype"):
        load_resampler_state(_mk_resampler(dtype=np.float32),
                             tmp_path / "cfg.npz")
    r3 = tar.new_resampler(tar.Config(
        48000, 8000, quality=tar.QualitySpec(
            preset=tar.QualityPreset.VERY_HIGH),
        dtype=np.float64, device="cpu"))
    assert len(r3._exec) == len(r._exec)
    with pytest.raises(ValueError, match="fingerprint"):
        load_resampler_state(r3, tmp_path / "cfg.npz")


def test_resampler_wrong_file_kind_rejected(tmp_path):
    save_stream_state(_rational_engine(), tmp_path / "engine.npz")
    with pytest.raises(ValueError, match="not a resampler state file"):
        load_resampler_state(_mk_resampler(), tmp_path / "engine.npz")


def test_resampler_stub_segment_rejected(tmp_path):
    """A file whose segment 0 is a stub does not restore into a resampler
    whose segment 0 is an engine: the diagnostic ValueError, not a
    KeyError from the missing engine keys."""
    save_resampler_state(_mk_resampler(), tmp_path / "real.npz")
    payload = {k: v for k, v in _payload(tmp_path / "real.npz").items()
               if not k.startswith("e0_")}
    payload["e0_stub"] = np.array([0, 0], dtype=np.int64)
    np.savez(tmp_path / "stubbed.npz", **payload)
    with pytest.raises(ValueError, match="kind mismatch"):
        load_resampler_state(_mk_resampler(), tmp_path / "stubbed.npz")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resampler_files_cross(writer, tmp_path):
    """A Resampler file written by either package resumes in the other
    within 1e-12 of the writer's uninterrupted run."""
    x = signals.sine(30000, 440.0, 48000.0)
    src_pkg, dst_pkg = (jar, tar) if writer == "jax" else (tar, jar)
    save, load = ((jck.save_resampler_state, load_resampler_state)
                  if writer == "jax" else
                  (save_resampler_state, jck.load_resampler_state))
    r_full = _mk_resampler(src_pkg)
    full = np.concatenate([r_full.process(x), r_full.flush()])
    r_a = _mk_resampler(src_pkg)
    part1 = r_a.process(x[:13000])
    save(r_a, tmp_path / "r.npz")
    r_b = _mk_resampler(dst_pkg)
    load(r_b, tmp_path / "r.npz")
    resumed = np.concatenate([part1, r_b.process(x[13000:]), r_b.flush()])
    assert resumed.shape == full.shape
    np.testing.assert_allclose(resumed, full, rtol=0, atol=TOL)


# -- the variable-rate resampler ---------------------------------------------

def _vr(pkg=tar, **kw):
    cls = VariableRateResampler if pkg is tar else JVR
    if pkg is tar:
        kw.setdefault("device", "cpu")
    return cls(4.0, 44100.0 / 48000.0, batch=2, block=512,
               dtype=np.float64, **kw)


def _vr_mid_slew(vr, seed):
    """Feed, set a slew, feed again: the snapshot lands mid-slew."""
    rng = np.random.default_rng(seed)
    vr.process(rng.standard_normal((2, 1800)) * 0.5)
    vr.set_io_ratio(0.5, slew_len=4000)
    vr.process(rng.standard_normal((2, 1500)) * 0.5)
    return rng.standard_normal((2, 2200)) * 0.5


@pytest.mark.parametrize("quality", ["vr", "vr-hq"])
def test_vr_bit_identical_resume_mid_slew(quality, tmp_path):
    va, vb = _vr(quality=quality), _vr(quality=quality)
    x3 = _vr_mid_slew(va, 3)
    save_vr_state(va, tmp_path / "vr.npz")
    load_vr_state(vb, tmp_path / "vr.npz")
    assert vb.get_statistics() == va.get_statistics()
    ya = np.concatenate([va.process(x3), va.flush()], axis=1)
    yb = np.concatenate([vb.process(x3), vb.flush()], axis=1)
    np.testing.assert_array_equal(ya, yb)
    assert ya.shape[1] > 0


@pytest.mark.parametrize("quality", ["vr", "vr-hq"])
def test_vr_files_cross_both_ways(quality, tmp_path):
    vj, vt = _vr(jar, quality=quality), _vr(quality=quality)
    x3 = _vr_mid_slew(vj, 4)
    _vr_mid_slew(vt, 4)
    jck.save_vr_state(vj, tmp_path / "j.npz")
    save_vr_state(vt, tmp_path / "t.npz")
    fj, ft = _payload(tmp_path / "j.npz"), _payload(tmp_path / "t.npz")
    assert fj.keys() == ft.keys()
    for k in fj:
        assert (fj[k].shape, fj[k].dtype) == (ft[k].shape, ft[k].dtype), k
    for k in ("magic", "fp", "icounters", "traj", "hold"):
        np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)
    for k in ("carry", "pre_carry"):
        np.testing.assert_allclose(fj[k], ft[k], rtol=0, atol=TOL)
    want_j = np.concatenate([vj.process(x3), vj.flush()], axis=1)
    want_t = np.concatenate([vt.process(x3), vt.flush()], axis=1)
    vt2, vj2 = _vr(quality=quality), _vr(jar, quality=quality)
    load_vr_state(vt2, tmp_path / "j.npz")
    jck.load_vr_state(vj2, tmp_path / "t.npz")
    _close(np.concatenate([vt2.process(x3), vt2.flush()], axis=1), want_j)
    _close(np.concatenate([vj2.process(x3), vj2.flush()], axis=1), want_t)


def test_vr_cross_config_restore_rejected(tmp_path):
    save_vr_state(_vr(), tmp_path / "vr.npz")
    with pytest.raises(ValueError, match="configuration"):
        load_vr_state(_vr(quality="vr-hq"), tmp_path / "vr.npz")


def test_vr_wrong_file_rejected(tmp_path):
    save_stream_state(_rational_engine(), tmp_path / "eng.npz")
    with pytest.raises(ValueError, match="VR state"):
        load_vr_state(_vr(), tmp_path / "eng.npz")
