"""Stream sharding (``go_audio_resampler_tpu_torch/parallel/mesh.py``)
against the JAX package's ``parallel/mesh.py`` on the conftest's 8
virtual CPU devices.

Each case of tests/test_parallel.py has a counterpart here, at the same
plans and sizes, in float64, held to 1e-12 against the JAX sharded
function (8 devices, one stream each) and against the port's serial
engine:

- one-rank cases on an in-process ``gloo`` mesh (set up once for the
  module and torn down at its end), 8 streams on the rank;
- multi-rank cases: 2 and 4 ranks spawned as processes (``gloo`` on a
  file store), 4 and 2 streams a rank, several topologies a spawn; the
  gathered rows are held to the same references, and the MAX
  ``all_reduce`` of the stream step's peak to the global max|y|;
- ``dispatch='tune'`` on 2 spawned ranks, each rank's measurement
  patched to its own winner: both pin rank 0's, and only rank 0 writes
  the tune cache.

The spawned ranks run a worker script written to the test's temporary
directory: they import neither JAX nor this module.  Each spawn ends
within its timeout or the test fails.
"""

import functools
import importlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from go_audio_resampler_tpu import parallel as jparallel
from go_audio_resampler_tpu.engine import plan_engine as jplan
from go_audio_resampler_tpu.engine.variable import (
    VariableRateResampler as JVR)
from go_audio_resampler_tpu.filterdesign import Quality as JQ
from go_audio_resampler_tpu.pipeline.fused import (BandedPlan as JBanded,
                                                   fuse_chain as jfuse)
from go_audio_resampler_tpu_torch import EngineCore, Quality, parallel
from go_audio_resampler_tpu_torch import plan_engine as tplan
from go_audio_resampler_tpu_torch.engine import VariableRateResampler
from go_audio_resampler_tpu_torch.pipeline.fused import BandedPlan, fuse_chain

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=0, atol=1e-12)
S = 8
#: tests/test_parallel.py's TestShardedEngineCore.CASES
CASES = [
    (44100, 48000, "HIGH", False),    # two_stage exact-rational
    (48000, 44100, "HIGH", False),    # two_stage frac-down
    (48000, 96000, "HIGH", False),    # dft_up
    (96000, 48000, "HIGH", False),    # decimate
    (44100, 48000, "QUICK", False),   # cubic
    (1000, 199500, "LOW", False),     # general path (clamped)
    (48000, 44100, "HIGH", True),     # strict-aa prefilter
]
SPAWN_TIMEOUT = 180


@pytest.fixture(scope="module")
def jmesh():
    return jparallel.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    m = parallel.make_mesh(1, device_type="cpu")
    yield m
    dist.destroy_process_group()


def _np(y):
    if isinstance(y, DTensor):
        y = y.full_tensor()
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _run(eng, x, chunks=None):
    parts = [eng.process(x[:, a:b]) for a, b in
             (chunks or [(0, x.shape[1])])]
    return np.concatenate(parts + [eng.flush()], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_engine(case, n=3000, seed=11):
    """The JAX ShardedEngineCore's stream of case ``case`` (8 devices,
    one stream each, block 512, float64)."""
    inr, outr, q, strict = case
    x = np.random.default_rng(seed).standard_normal((S, n))
    eng = jparallel.ShardedEngineCore(jplan(inr, outr, JQ[q], strict),
                                      jparallel.make_mesh(8),
                                      batch_per_device=1, block=512,
                                      dtype=np.float64)
    return x, _run(eng, x)


def _serial(plan, x, block=512):
    return _run(EngineCore(plan, batch=x.shape[0], block=block,
                           dtype=np.float64, device="cpu"), x)


def _sharded(mesh, plan, bpd=S, block=512):
    return parallel.ShardedEngineCore(plan, mesh, batch_per_device=bpd,
                                      block=block, dtype=np.float64)


# -- one rank ----------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}"
                         f"{'-strict' if c[3] else ''}")
def test_matches_serial_engine(mesh, case):
    x, want = _jax_engine(case)
    plan = tplan(case[0], case[1], Quality[case[2]], case[3])
    got = _run(_sharded(mesh, plan), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, _serial(plan, x))


def test_chunked_streaming_and_reset(mesh):
    x = np.random.default_rng(12).standard_normal((S, 2500))
    jeng = jparallel.ShardedEngineCore(jplan(44100, 48000, JQ.HIGH),
                                       jparallel.make_mesh(8), 1, 512,
                                       np.float64)
    want = _run(jeng, x, [(0, 700), (700, 703), (703, 2500)])
    eng = _sharded(mesh, tplan(44100, 48000, Quality.HIGH))
    got = _run(eng, x, [(0, 700), (700, 703), (703, 2500)])
    np.testing.assert_allclose(got, want, **TOL)
    eng.reset()
    np.testing.assert_allclose(_run(eng, x), want, **TOL)


def test_scan_multiblock_path(mesh):
    """One large call (more than SCAN_BLOCKS blocks)."""
    x, want = _jax_engine(CASES[0], n=9000, seed=13)
    got = _run(_sharded(mesh, tplan(44100, 48000, Quality.HIGH)), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_state_stays_sharded(mesh):
    """The engine's state is the rank's rows on its device (the JAX
    engine's state leaves are sharded over the 8 devices)."""
    eng = _sharded(mesh, tplan(44100, 48000, Quality.HIGH))
    eng.process(np.zeros((S, 512)))
    assert eng.batch == S and eng.state.shape[0] == S
    assert eng.state.device == parallel.mesh.rank_device(mesh)
    assert not isinstance(eng.state, DTensor)


def _jax_device(jmesh, plan, x):
    eng = jparallel.ShardedEngineCore(plan, jmesh, batch_per_device=1,
                                      block=512, dtype=np.float64)
    y1 = eng.process_device(jnp.asarray(x))
    y2 = eng.flush_device()
    assert y1.shape[1] == 0 or len(y1.sharding.device_set) == 8
    return np.concatenate([np.asarray(y1), np.asarray(y2)], axis=1)


def _device_run(eng, x):
    y1 = eng.process_device(torch.from_numpy(x))
    y2 = eng.flush_device()
    for y in (y1, y2):
        assert isinstance(y, DTensor) and y.placements == (Shard(0),)
        assert y.to_local().shape[0] == eng.batch
    return np.concatenate([_np(y1), _np(y2)], axis=1)


def test_device_mode_matches_serial_and_stays_sharded(mesh, jmesh):
    plan = tplan(44100, 48000, Quality.HIGH)
    eng = _sharded(mesh, plan)
    mult = eng.device_chunk_multiple
    assert mult is not None
    x = np.random.default_rng(21).standard_normal((S, 6 * mult))
    got = _device_run(eng, x)
    want = _jax_device(jmesh, jplan(44100, 48000, JQ.HIGH), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, _serial(plan, x))


def test_banded_composite_device_mode(mesh, jmesh):
    plans = [tplan(48000, 24000, Quality.HIGH),
             tplan(24000, 22050, Quality.HIGH, True)]
    op = fuse_chain(plans)
    assert op is not None and op.n_head > 0
    bplan = BandedPlan(op, ratio=22050.0 / 48000.0)
    eng = _sharded(mesh, bplan)
    x = np.random.default_rng(22).standard_normal(
        (S, 4 * eng.device_chunk_multiple))
    got = _device_run(eng, x)
    jop = jfuse([jplan(48000, 24000, JQ.HIGH),
                 jplan(24000, 22050, JQ.HIGH, True)])
    want = _jax_device(jmesh, JBanded(jop, ratio=22050.0 / 48000.0), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, _serial(bplan, x))


def test_stream_matches_serial(mesh):
    x, want = _jax_engine(CASES[0], n=5000, seed=29)
    eng = _sharded(mesh, tplan(44100, 48000, Quality.HIGH))
    outs = list(eng.stream([x[:, :1777], x[:, 1777:]]))
    assert all(isinstance(o, np.ndarray) for o in outs)
    got = np.concatenate(outs, axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_stream_device_out_stays_sharded(mesh):
    eng = _sharded(mesh, tplan(44100, 48000, Quality.HIGH))
    x = np.random.default_rng(31).standard_normal(
        (S, 8 * eng.device_chunk_multiple))
    outs = list(eng.stream([x], out="device"))
    assert outs and all(isinstance(o, DTensor) and o.placements ==
                        (Shard(0),) for o in outs)
    got = np.concatenate([_np(o) for o in outs], axis=1)
    np.testing.assert_array_equal(
        got, _serial(tplan(44100, 48000, Quality.HIGH), x))


def test_stream_walk_falls_back_to_process(mesh):
    """A topology without static counts streams through process()."""
    x, want = _jax_engine(CASES[5])
    eng = _sharded(mesh, tplan(1000, 199500, Quality.LOW))
    got = np.concatenate(list(eng.stream([x[:, :1000], x[:, 1000:]])),
                         axis=1)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(NotImplementedError):
        list(eng.stream([x], out="device"))


def test_sharded_oneshot_matches_jax(mesh, jmesh):
    x = np.random.default_rng(0).normal(size=(16, 1500))
    y = parallel.sharded_oneshot(tplan(44100, 48000, Quality.HIGH), x, mesh,
                                 dtype=torch.float64)
    assert isinstance(y, DTensor) and y.placements == (Shard(0),)
    want = np.asarray(jparallel.sharded_oneshot(
        jplan(44100, 48000, JQ.HIGH), x, jmesh, dtype=jnp.float64))
    np.testing.assert_allclose(_np(y), want, **TOL)


def test_sharded_oneshot_layout(mesh):
    x = np.zeros((8, 441), np.float32)
    y = parallel.sharded_oneshot(tplan(44100, 48000, Quality.HIGH), x, mesh)
    assert y.placements == (Shard(0),) and y.dtype == torch.float32
    assert y.device_mesh is mesh and y.to_local().shape[0] == 8


def test_global_stats_matches_jax(mesh, jmesh):
    x = np.random.default_rng(1).normal(size=(16, 256))
    rms, peak = parallel.global_stream_stats(x, mesh)
    jrms, jpeak = jparallel.global_stream_stats(x, jmesh)
    assert abs(float(rms) - float(jrms)) <= 1e-12
    assert float(peak) == float(jpeak) == float(np.abs(x).max())
    assert float(rms) == pytest.approx(float(np.sqrt((x * x).mean())),
                                       rel=1e-12)


def _jax_step_stream(jmesh, plan, x, blk, steps):
    init, step, jblk = jparallel.sharded_stream_step(
        plan, jmesh, batch_per_device=1, block=blk, dtype=jnp.float64)
    state, outs, peaks = init(), [], []
    for i in range(steps):
        state, y, n, peak = step(state, jnp.asarray(
            x[:, i * jblk:(i + 1) * jblk]))
        outs.append(np.asarray(y)[:, :int(n)])
        peaks.append(float(peak))
    return jblk, np.concatenate(outs, axis=1), peaks


def _step_stream(mesh, plan, x, blk, steps, bpd=S):
    init, step, tblk = parallel.sharded_stream_step(
        plan, mesh, batch_per_device=bpd, block=blk, dtype=torch.float64)
    state, outs, peaks = init(), [], []
    for i in range(steps):
        state, y, n, peak = step(state, x[:, i * tblk:(i + 1) * tblk])
        assert isinstance(y, DTensor) and isinstance(n, int)
        assert peak.dim() == 0 and not isinstance(peak, DTensor)
        full = _np(y)
        assert float(peak) == (np.abs(full).max() if full.size else 0.0)
        outs.append(full[:, :n])
        peaks.append(float(peak))
    return tblk, np.concatenate(outs, axis=1), peaks


def test_step_carries_state(mesh, jmesh):
    """The exact branch (K1's function): each step's stream and peak
    equal the JAX step's; after the ramp, the stream equals oneshot."""
    x = np.random.default_rng(2).normal(size=(S, 4 * 147))
    jblk, want, jpeaks = _jax_step_stream(
        jmesh, jplan(44100, 48000, JQ.HIGH), x, 128, 4)
    blk, got, peaks = _step_stream(mesh, tplan(44100, 48000, Quality.HIGH),
                                   x, 128, 4)
    assert blk == jblk == 147
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(peaks, jpeaks, **TOL)
    osm = importlib.import_module(
        "go_audio_resampler_tpu_torch.engine.oneshot")
    plan = tplan(44100, 48000, Quality.HIGH)
    r, _, ipx, lam = osm._fused_rational_matrix(plan)
    r, ipx = osm.superframe(r, ipx, kf_cap=max(1, 128 // ipx))
    carry = lam + -(-max(r.shape[1] - ipx - lam, 0) // ipx) * ipx
    drop = ((carry - lam) // ipx) * r.shape[0]
    ref = osm.oneshot(plan, x, dtype=torch.float64, device="cpu").numpy()
    m = min(ref.shape[1], got.shape[1] - drop)
    assert m > 200
    np.testing.assert_allclose(got[:, drop:drop + m], ref[:, :m], atol=1e-12)


def test_high_ratio_block_clamped_and_matches_serial(mesh, jmesh):
    """The poly-walk branch clamps its block so that a step's output cap
    stays within 2^15; its stream equals the JAX step's and, after the
    transient, the serial engine's."""
    plan = tplan(1000.0, 199500.0, Quality.LOW)
    assert plan.kind == "two_stage" and not plan.is_rational_exact
    x = np.random.default_rng(3).normal(size=(S, 2 * 2048))
    jblk, want, jpeaks = _jax_step_stream(
        jmesh, jplan(1000.0, 199500.0, JQ.LOW), x, 2048, 2)
    blk, got, peaks = _step_stream(mesh, plan, x, 2048, 2)
    assert blk == jblk < 2048
    assert -(-blk * plan.factor * plan.num_phases * 65536 // plan.step) \
        + 1 <= 32767
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(peaks, jpeaks, **TOL)
    ref = _run(EngineCore(plan, batch=S, block=blk, dtype=np.float64,
                          device="cpu"), x[:, :2 * blk])
    got = got[:, plan.lengths.drop_prefix():]
    m = min(got.shape[1], ref.shape[1])
    assert m > 100
    np.testing.assert_allclose(got[:, :m], ref[:, :m], atol=1e-12)


def test_step_rejects_unsupported_plans(mesh):
    with pytest.raises(ValueError, match="two_stage"):
        parallel.sharded_stream_step(tplan(96000, 48000, Quality.HIGH),
                                     mesh, S, 512)
    with pytest.raises(ValueError, match="strict-antialias"):
        parallel.sharded_stream_step(tplan(48000, 44099, Quality.HIGH, True),
                                     mesh, S, 512)


def test_sharded_vr_matches_serial(mesh):
    """tests/test_parallel.py's VR case: 16 streams (two a device there),
    mid-slew."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(16, 6000))
    kw = dict(dtype=np.float64, block=1024)
    sh = parallel.ShardedVariableRateResampler(
        2.0, 0.9, mesh=mesh, batch_per_device=16, **kw)
    sh.set_io_ratio(1.1, slew_len=2000)
    jsh = jparallel.ShardedVariableRateResampler(
        2.0, 0.9, mesh=jparallel.make_mesh(), batch_per_device=2, **kw)
    jsh.set_io_ratio(1.1, slew_len=2000)
    ser = VariableRateResampler(2.0, 0.9, batch=16, device="cpu", **kw)
    ser.set_io_ratio(1.1, slew_len=2000)
    got, want, ref = (_run(e, x) for e in (sh, jsh, ser))
    assert got.shape == want.shape == ref.shape
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-12)
    np.testing.assert_array_equal(got, ref)
    assert sh._carry.shape[0] == 16


def test_sharded_vr_device_matches_serial(mesh, jmesh):
    x = np.random.default_rng(53).standard_normal((S, 4 * 1024)) * 0.5
    kw = dict(block=1024, dtype=np.float64)
    jsh = jparallel.ShardedVariableRateResampler(
        2.0, 0.9, mesh=jmesh, batch_per_device=1, **kw)
    jsh.set_io_ratio(1.2, slew_len=1500)
    want = np.concatenate([np.asarray(jsh.process_device(jnp.asarray(x))),
                           np.asarray(jsh.flush_device())], axis=1)
    sh = parallel.ShardedVariableRateResampler(
        2.0, 0.9, mesh=mesh, batch_per_device=S, **kw)
    sh.set_io_ratio(1.2, slew_len=1500)
    y, t = sh.process_device(torch.from_numpy(x)), sh.flush_device()
    assert isinstance(y, DTensor) and y.placements == (Shard(0),)
    got = np.concatenate([_np(y), _np(t)], axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_global_batch_checked(mesh):
    eng = _sharded(mesh, tplan(44100, 48000, Quality.HIGH))
    with pytest.raises(ValueError, match="global batch"):
        eng.process(np.zeros((4, 100)))
    with pytest.raises(ValueError, match="global batch"):
        eng.process_device(torch.zeros((4, 147), dtype=torch.float64))


def test_make_mesh_needs_a_group_above_one_rank(mesh):
    with pytest.raises(ValueError, match="1 ranks"):
        parallel.make_mesh(2, device_type="cpu")
    assert parallel.make_mesh(device_type="cpu").size() == 1
    with pytest.raises(ValueError, match="device_type"):
        parallel.make_mesh(1, device_type="tpu")


def test_make_mesh_card_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(1)


# -- spawned ranks -----------------------------------------------------------

WORKER = textwrap.dedent('''
    import json, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from go_audio_resampler_tpu_torch import Quality, parallel, plan_engine

    cases = json.loads(sys.argv[5])
    mesh = parallel.make_mesh(world, device_type="cpu")
    bpd = 8 // world
    res = {}

    def run(eng, x):
        return np.concatenate([eng.process(x), eng.flush()], axis=1)

    for inr, outr, q, strict in cases:
        x = np.random.default_rng(11).standard_normal((8, 3000))
        eng = parallel.ShardedEngineCore(
            plan_engine(inr, outr, Quality[q], strict), mesh,
            batch_per_device=bpd, block=512, dtype=np.float64)
        res[f"eng_{inr}_{outr}_{q}_{strict}"] = run(eng, x)
        state = eng.state[1] if isinstance(eng.state, tuple) else eng.state
        state = getattr(state, "hist", getattr(state, "carry", state))
        assert state.shape[0] == bpd, state.shape

    plan = plan_engine(44100, 48000, Quality.HIGH)
    eng = parallel.ShardedEngineCore(plan, mesh, batch_per_device=bpd,
                                     block=512, dtype=np.float64)
    x = np.random.default_rng(21).standard_normal(
        (8, 6 * eng.device_chunk_multiple))
    y1 = eng.process_device(torch.from_numpy(x))
    y2 = eng.flush_device()
    assert y1.to_local().shape[0] == bpd
    res["device"] = torch.cat([y1.full_tensor(), y2.full_tensor()],
                              dim=1).numpy()

    x = np.random.default_rng(2).normal(size=(8, 4 * 147))
    init, step, blk = parallel.sharded_stream_step(plan, mesh, bpd, 128,
                                                   torch.float64)
    state, outs, peaks = init(), [], []
    for i in range(4):
        state, y, n, peak = step(state, x[:, i * blk:(i + 1) * blk])
        full = y.full_tensor()
        assert float(peak) == float(full.abs().max())
        assert float(y.to_local().abs().max()) <= float(peak)
        outs.append(full[:, :n].numpy())
        peaks.append(float(peak))
    res["step"] = np.concatenate(outs, axis=1)
    res["step_peaks"] = np.array(peaks)

    x = np.random.default_rng(0).normal(size=(16, 1500))
    res["oneshot"] = parallel.sharded_oneshot(
        plan, x, mesh, dtype=torch.float64).full_tensor().numpy()
    x = np.random.default_rng(1).normal(size=(16, 256))
    res["stats"] = np.array([float(v) for v in
                             parallel.global_stream_stats(x, mesh)])

    x = np.random.default_rng(53).standard_normal((8, 4 * 1024)) * 0.5
    vr = parallel.ShardedVariableRateResampler(
        2.0, 0.9, mesh=mesh, batch_per_device=bpd, block=1024,
        dtype=np.float64)
    vr.set_io_ratio(1.2, slew_len=1500)
    res["vr"] = run(vr, x)
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
''')
SPAWN_CASES = [CASES[0], CASES[3], CASES[5], CASES[6]]

#: dispatch='tune' on every rank, measured on the CPU (the seam that gates
#: measurement on the card forced open), with each rank's measurement
#: patched to its own winner: every rank must pin rank 0's, and only rank
#: 0 writes the tune cache (one file a rank).
TUNE_WORKER = textwrap.dedent('''
    import json, os, sys
    from datetime import timedelta
    import numpy as np
    import torch.distributed as dist

    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    os.environ["GAR_TUNE_CACHE_FILE"] = f"{out}.{rank}.json"
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from go_audio_resampler_tpu_torch import Quality, parallel, plan_engine
    from go_audio_resampler_tpu_torch.engine import streaming

    mine = "pallas" if rank == 0 else "xla"
    streaming._tune_measures = lambda device: True
    streaming._slope_measure = (lambda fns, depths, iters=5, timer=None:
                                (mine, 1e-2, 1e-4))
    eng = parallel.ShardedEngineCore(
        plan_engine(44100, 48000, Quality.HIGH), parallel.make_mesh(
            world, device_type="cpu"), batch_per_device=2, block=256,
        dtype=np.float64, dispatch="tune")
    dist.barrier()
    pins = [None] * world
    dist.all_gather_object(pins, eng.dispatch)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"pins": pins, "caches": [
                os.path.exists(f"{out}.{r}.json") for r in range(world)]},
                f)
    dist.barrier()
    dist.destroy_process_group()
''')


def _spawn(tmp_path, world, worker=WORKER, out_name="out.npz"):
    """Run ``worker`` on ``world`` ranks; the path of rank 0's results.
    Every rank is killed, and the test fails, past SPAWN_TIMEOUT."""
    script = tmp_path / "worker.py"
    script.write_text(worker)
    out = tmp_path / out_name
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / "store"), str(out), json.dumps(SPAWN_CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} spawned ranks did not end within "
                    f"{SPAWN_TIMEOUT} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return out


def test_spawned_ranks_pin_rank_0s_tune(tmp_path):
    res = json.loads(_spawn(tmp_path, 2, TUNE_WORKER,
                            "tune.json").read_text())
    assert res == {"pins": ["pallas", "pallas"], "caches": [True, False]}


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_ranks_match_jax_and_serial(tmp_path, jmesh, world):
    res = dict(np.load(_spawn(tmp_path, world)))
    for case in SPAWN_CASES:
        x, want = _jax_engine(case)
        got = res["eng_{}_{}_{}_{}".format(*case)]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
        # A rank's products over fewer rows may round differently on
        # the CPU: 1e-12, not bit for bit.
        np.testing.assert_allclose(
            got, _serial(tplan(case[0], case[1], Quality[case[2]], case[3]),
                         x), **TOL)

    mult = EngineCore(tplan(44100, 48000, Quality.HIGH), block=512,
                      device="cpu").device_chunk_multiple
    x = np.random.default_rng(21).standard_normal((S, 6 * mult))
    np.testing.assert_allclose(
        res["device"], _jax_device(jmesh, jplan(44100, 48000, JQ.HIGH), x),
        **TOL)

    x = np.random.default_rng(2).normal(size=(S, 4 * 147))
    _, want, jpeaks = _jax_step_stream(
        jmesh, jplan(44100, 48000, JQ.HIGH), x, 128, 4)
    np.testing.assert_allclose(res["step"], want, **TOL)
    np.testing.assert_allclose(res["step_peaks"], jpeaks, **TOL)

    x = np.random.default_rng(0).normal(size=(16, 1500))
    np.testing.assert_allclose(res["oneshot"], np.asarray(
        jparallel.sharded_oneshot(jplan(44100, 48000, JQ.HIGH), x, jmesh,
                                  dtype=jnp.float64)), **TOL)
    x = np.random.default_rng(1).normal(size=(16, 256))
    jrms, jpeak = jparallel.global_stream_stats(x, jmesh)
    np.testing.assert_allclose(res["stats"], [float(jrms), float(jpeak)],
                               rtol=1e-12, atol=0)

    x = np.random.default_rng(53).standard_normal((S, 4 * 1024)) * 0.5
    ser = JVR(2.0, 0.9, batch=S, block=1024, dtype=np.float64)
    ser.set_io_ratio(1.2, slew_len=1500)
    np.testing.assert_allclose(res["vr"], _run(ser, x), rtol=1e-12,
                               atol=1e-12)
