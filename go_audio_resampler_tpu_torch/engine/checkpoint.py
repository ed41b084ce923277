"""Stream state checkpoint / resume.

PyTorch counterpart of the JAX package's ``engine/checkpoint.py``, with
its file format: the same npz keys, magic strings, dtypes and validation
messages, so that a file written by either package loads into the other.

The reference's streaming state is an enumerable set of per-stage buffers
and accumulators (history tails, fixed-point ``at``, ``decimPhase``, the
cubic window) which ``Reset()`` zeroes, including the inter-stage ring
buffers (internal/pipeline/buffer.go:12-172).  Here that state is a few
tensors and host integers, so checkpointing a live stream is a
serialization of arrays: a stream can be snapshotted mid-flight, the
process restarted, and processing resumed with bit-identical
continuation.  Tensors are read to the host on save and put on the
engine's device on load.

Three granularities:

- :func:`save_stream_state` / :func:`load_stream_state`: one
  :class:`EngineCore` (the direct-engine path).  The payload covers the
  step state, the host FIFO, the emission counters, the strict-aa
  prefilter stream, and the banded composite's collected input prefix
  (``head_x``), without which a snapshot taken before the aperiodic head
  drains would resume with wrong first outputs.
- :func:`save_resampler_state` / :func:`load_resampler_state`: the public
  ``api.Resampler`` (the ``New()`` pipeline path): every execution
  segment's engine state plus the wrapper's own output queue, counters,
  entry mode and flushed flag (the analog of the reference's per-channel
  stage chains + ring buffers, constant.go:42-85).
- :func:`save_vr_state` / :func:`load_vr_state`: the variable-rate
  resampler: host hold, device carries, and the closed-form ratio
  trajectory (a ``soxr_set_io_ratio`` slew survives the snapshot
  mid-slew).

The step state is written as ``leaf_0..leaf_n`` in the order in which the
JAX package flattens its state pytree, each host integer as a 0-d int32
array: the fused banded, decimation and FFT decimation steps one carry;
dft_up the prestage carry; cubic ``carry, at_int, at_f1, at_f0``; the
general walk ``carry, hist, hist_len, at_hi, at_lo``.
"""

from __future__ import annotations

import io
import pathlib

import numpy as np
import torch

from .stages import CubicState, PolyState, PrestageState
from .streaming import EngineCore

_MAGIC = "gar_tpu_stream_state_v1"
_MAGIC_R = "gar_tpu_resampler_state_v1"


# -- the step state as the JAX package's pytree leaves -----------------------

def _state_leaves(state) -> list:
    """``EngineCore.state`` as a list of leaves (tensors and host ints) in
    the JAX package's flatten order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, PrestageState):
        return [state.carry]
    if isinstance(state, CubicState):
        return [state.carry, state.at_int, state.at_f1, state.at_f0]
    pre, poly = state
    return [pre.carry, poly.hist, poly.hist_len, poly.at_hi, poly.at_lo]


def _state_from_leaves(like, leaves: list):
    """The inverse of :func:`_state_leaves` for a state shaped as
    ``like``."""
    if isinstance(like, torch.Tensor):
        return leaves[0]
    if isinstance(like, PrestageState):
        return PrestageState(carry=leaves[0])
    if isinstance(like, CubicState):
        return CubicState(*leaves)
    return (PrestageState(carry=leaves[0]), PolyState(*leaves[1:]))


def _host(leaf) -> np.ndarray:
    """A leaf as the file holds it: a tensor's values on the host, a host
    integer as a 0-d int32 array (the JAX package's int32 scalars)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, dtype=np.int32)


def _leaf_spec(leaf) -> tuple[tuple, np.dtype]:
    """(shape, numpy dtype) of a leaf as :func:`_host` writes it."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape),
                np.dtype(str(leaf.dtype).removeprefix('torch.')))
    return (), np.dtype(np.int32)


# -- per-engine payload (shared by both granularities) -----------------------

def _engine_payload(engine: EngineCore) -> dict:
    d = {f"leaf_{i}": _host(l)
         for i, l in enumerate(_state_leaves(engine.state))}
    d["pending"] = engine._pending.snapshot()
    d["counters"] = np.array([
        engine.samples_in, engine.samples_out, engine._core_emitted,
        1 if engine._flushed else 0], dtype=np.int64)
    # Identity of the plan this state belongs to: catches cross-config
    # restores that happen to have matching leaf shapes.
    d["plan_fp"] = np.array(repr(engine.plan.fingerprint))
    if engine._head_t is not None:
        # Collected input prefix for the banded composite's aperiodic
        # head rows (the engine keeps it behind lam zeros).
        lam = engine.plan.op.lam
        d["head_x"] = _host(
            engine._head_xe[:, lam:lam + engine._head_have]).astype(
                np.float64)
    if engine._has_aa:
        d["aa_carry"] = _host(engine._aa_carry)
        d["aa_raw"] = engine._aa_raw.snapshot()
        d["aa_counters"] = np.array(
            [engine._aa_causal, engine._aa_delivered], dtype=np.int64)
    return d


def _restore_head(engine: EngineCore, data, has, g) -> None:
    """The composite's input prefix from the file (or, for a file
    without one, an empty prefix past the head region)."""
    n_head = engine._head_t.shape[1]
    lam = engine.plan.op.lam
    engine._head_xe.zero_()
    engine._head_have = 0
    if has("head_x"):
        hx = g("head_x")
        if hx.shape[0] != engine.batch:
            raise ValueError(
                f"head prefix batch mismatch: engine has "
                f"{engine.batch} streams, checkpoint has {hx.shape[0]}")
        room = engine._head_xe.shape[1] - lam
        if hx.shape[1] > room:
            raise ValueError(
                f"head prefix length mismatch: engine keeps {room} "
                f"samples, checkpoint has {hx.shape[1]} (plan must match)")
        engine._head_xe[:, lam:lam + hx.shape[1]] = torch.as_tensor(
            np.asarray(hx, dtype=np.float64)).to(engine._head_xe)
        engine._head_have = hx.shape[1]
    elif engine.samples_out < n_head:
        raise ValueError(
            "checkpoint lacks the banded head input prefix (head_x) "
            "but the stream is still inside its aperiodic head region "
            f"({engine.samples_out} < {n_head} "
            "outputs); it was written by an older version and cannot "
            "resume exactly")


def _engine_restore(engine: EngineCore, data, prefix: str = "") -> None:
    def g(k):
        return data[prefix + k]

    def has(k):
        return (prefix + k) in data.files

    if has("plan_fp"):
        fp = str(g("plan_fp"))
        want = repr(engine.plan.fingerprint)
        if fp != want:
            raise ValueError(
                "checkpoint was taken from a different resampler "
                f"configuration (plan fingerprint mismatch at {prefix!r})")
    new_leaves = []
    for i, cur in enumerate(_state_leaves(engine.state)):
        arr = g(f"leaf_{i}")
        shape, dtype = _leaf_spec(cur)
        if shape != arr.shape:
            raise ValueError(
                f"state leaf {i} shape mismatch: engine has "
                f"{shape}, checkpoint has {arr.shape} "
                "(plan/batch/block/dtype must match)")
        if dtype != arr.dtype:
            raise ValueError(
                f"state leaf {i} dtype mismatch: engine has "
                f"{dtype}, checkpoint has {arr.dtype} "
                "(plan/batch/block/dtype must match)")
        new_leaves.append(torch.as_tensor(arr).to(engine.device)
                          if isinstance(cur, torch.Tensor) else int(arr))
    engine.state = _state_from_leaves(engine.state, new_leaves)
    engine._pending.reset()
    engine._pending.write(g("pending"))
    counters = g("counters")
    engine.samples_in = int(counters[0])
    engine.samples_out = int(counters[1])
    engine._core_emitted = int(counters[2])
    engine._flushed = bool(counters[3])
    if engine._head_t is not None:
        _restore_head(engine, data, has, g)
    if engine._has_aa != has("aa_carry"):
        raise ValueError(
            "prefilter state mismatch: engine and checkpoint disagree "
            "on strict_antialias (plan must match)")
    if engine._has_aa:
        carry = g("aa_carry")
        shape, dtype = _leaf_spec(engine._aa_carry)
        if shape != carry.shape or dtype != carry.dtype:
            raise ValueError(
                f"prefilter carry mismatch: engine has "
                f"{shape}/{dtype}, checkpoint has "
                f"{carry.shape}/{carry.dtype}")
        engine._aa_carry = torch.as_tensor(carry).to(engine.device)
        engine._aa_raw.reset()
        engine._aa_raw.write(g("aa_raw"))
        aa_counters = g("aa_counters")
        engine._aa_causal = int(aa_counters[0])
        engine._aa_delivered = int(aa_counters[1])


def _write_npz(payload: dict, path) -> None:
    buf = io.BytesIO()
    np.savez(buf, **payload)
    pathlib.Path(path).write_bytes(buf.getvalue())


# -- EngineCore (direct-engine path) ------------------------------------------

def save_stream_state(engine: EngineCore, path) -> None:
    """Snapshot an EngineCore's live streaming state to ``path`` (.npz)."""
    payload = _engine_payload(engine)
    payload["magic"] = np.frombuffer(_MAGIC.encode(), dtype=np.uint8)
    _write_npz(payload, path)


def load_stream_state(engine: EngineCore, path) -> None:
    """Restore a snapshot taken by :func:`save_stream_state`.

    The engine must have been constructed with the same plan, batch, block
    and dtype as the one that was saved (validated via the plan
    fingerprint and leaf-by-leaf shape checks).
    """
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        magic = bytes(data["magic"]).decode()
        if magic != _MAGIC:
            raise ValueError(f"not a stream state file: {path}")
        _engine_restore(engine, data)


# -- api.Resampler (public pipeline path) -------------------------------------

def save_resampler_state(resampler, path) -> None:
    """Snapshot a public ``api.Resampler`` (the ``New()`` pipeline path).

    Covers every execution segment (fused banded composites and per-stage
    engines alike) plus the wrapper's output queue, sample counters, entry
    mode and flushed flag: the complete state enumeration, mirroring the
    reference's per-channel chains + inter-stage ring buffers
    (constant.go:42-85, buffer.go:12-172).
    """
    payload = {
        "magic": np.frombuffer(_MAGIC_R.encode(), dtype=np.uint8),
        "n_exec": np.int64(len(resampler._exec)),
        "channels": np.int64(resampler.config.channels),
        "dtype": np.array(str(resampler.dtype)),
        "r_counters": np.array([
            resampler.samples_in, resampler.samples_out,
            1 if resampler._flushed else 0], dtype=np.int64),
        "entry_mode": np.array(resampler._entry_mode or ""),
        "out_queue": np.asarray(resampler._out_queue),
    }
    for i, eng in enumerate(resampler._exec):
        if isinstance(eng, EngineCore):
            for k, v in _engine_payload(eng).items():
                payload[f"e{i}_{k}"] = v
        else:   # StubEngine: counters only (no filter state)
            payload[f"e{i}_stub"] = np.array(
                [eng.samples_in, eng.samples_out], dtype=np.int64)
    _write_npz(payload, path)


def load_resampler_state(resampler, path) -> None:
    """Restore a snapshot taken by :func:`save_resampler_state`.

    ``resampler`` must have been built from the same Config (same rates,
    quality, channels, dtype, fusion environment) as the saved one.
    """
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        magic = bytes(data["magic"]).decode()
        if magic != _MAGIC_R:
            raise ValueError(f"not a resampler state file: {path}")
        if int(data["n_exec"]) != len(resampler._exec):
            raise ValueError(
                f"execution chain mismatch: resampler has "
                f"{len(resampler._exec)} segments, checkpoint has "
                f"{int(data['n_exec'])} (Config/fusion env must match)")
        if int(data["channels"]) != resampler.config.channels:
            raise ValueError(
                f"channel count mismatch: resampler has "
                f"{resampler.config.channels}, checkpoint has "
                f"{int(data['channels'])}")
        if str(data["dtype"]) != str(resampler.dtype):
            raise ValueError(
                f"dtype mismatch: resampler has {resampler.dtype}, "
                f"checkpoint has {data['dtype']}")
        for i, eng in enumerate(resampler._exec):
            if isinstance(eng, EngineCore):
                if f"e{i}_stub" in data.files:
                    raise ValueError(
                        f"segment {i} kind mismatch: resampler has an "
                        "engine stage, checkpoint has a stub (Config/"
                        "fusion env must match)")
                _engine_restore(eng, data, prefix=f"e{i}_")
            else:
                if f"e{i}_stub" not in data.files:
                    raise ValueError(
                        f"segment {i} kind mismatch: resampler has a stub "
                        "stage, checkpoint has an engine")
                stub = data[f"e{i}_stub"]
                eng.samples_in = int(stub[0])
                eng.samples_out = int(stub[1])
        counters = data["r_counters"]
        resampler.samples_in = int(counters[0])
        resampler.samples_out = int(counters[1])
        resampler._flushed = bool(counters[2])
        mode = str(data["entry_mode"])
        resampler._entry_mode = mode or None
        resampler._out_queue = np.asarray(data["out_queue"],
                                          dtype=resampler.dtype)


# -- VariableRateResampler ----------------------------------------------------

_MAGIC_V = "gar_tpu_vr_state_v1"


def _vr_fp(vr) -> str:
    return repr((vr.max_ratio, vr.batch, vr.block, str(vr.dtype),
                 vr.quality))


def save_vr_state(vr, path) -> None:
    """Snapshot a live :class:`~.variable.VariableRateResampler`.

    The VR state is the host input hold, the device cubic/prestage
    carries, the closed-form ratio trajectory (anchor, su, su_end, du,
    slew_n, k; soxr_set_io_ratio slews survive the snapshot mid-slew),
    and the feed counters.  A fingerprint of the construction parameters
    rejects cross-config restores.
    """
    payload = {
        "magic": np.frombuffer(_MAGIC_V.encode(), dtype=np.uint8),
        "fp": np.array(_vr_fp(vr)),
        "hold": np.asarray(vr._hold),
        "carry": _host(vr._carry),
        "pre_carry": _host(vr._pre_carry),
        "traj": np.array([vr._anchor, vr._su, vr._su_end, vr._du],
                         dtype=np.float64),
        "icounters": np.array([vr._k, vr._slew_n, vr._u_fed, vr._in_fed,
                               vr.samples_in, vr.samples_out],
                              dtype=np.int64),
    }
    _write_npz(payload, path)


def load_vr_state(vr, path) -> None:
    """Restore a snapshot taken by :func:`save_vr_state`.

    ``vr`` must have been constructed with the same max_ratio, batch,
    block, dtype and quality as the saved one; continuation is
    bit-identical (positions are closed-form from the restored anchor,
    never accumulated, so the restore cannot perturb rounding).
    """
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        magic = bytes(data["magic"]).decode()
        if magic != _MAGIC_V:
            raise ValueError(f"not a VR state file: {path}")
        if str(data["fp"]) != _vr_fp(vr):
            raise ValueError(
                "checkpoint was taken from a different VR configuration "
                "(max_ratio/batch/block/dtype/quality must match)")
        vr._hold = np.asarray(data["hold"], dtype=vr.dtype)
        vr._carry = torch.as_tensor(data["carry"]).to(vr.device)
        vr._pre_carry = torch.as_tensor(data["pre_carry"]).to(vr.device)
        traj = data["traj"]
        vr._anchor = float(traj[0])
        vr._su = float(traj[1])
        vr._su_end = float(traj[2])
        vr._du = float(traj[3])
        ic = data["icounters"]
        (vr._k, vr._slew_n, vr._u_fed, vr._in_fed,
         vr.samples_in, vr.samples_out) = (int(v) for v in ic)
