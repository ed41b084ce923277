"""PyTorch port vs JAX package: the streaming engine, end to end.

The port's ``EngineCore`` runs on ``device='cpu'`` (the plain versions of
its kernels) against the JAX package's ``EngineCore`` on the CPU, both fed
the same numpy inputs: float64 to 1e-12, float32 to 2e-5, with identical
output lengths, for every topology the port streams: the fused banded
steps (exact-rational two-stage, decimation), the general walk of
non-exact ratios, cubic and dft_up.  The engine on the card is checked in
``test_torch_cuda.py``.
"""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.engine.streaming import EngineCore as JEngine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
import go_audio_resampler_tpu_torch as gart
from go_audio_resampler_tpu_torch.engine import EngineCore, plan_from_arrays
from go_audio_resampler_tpu_torch.engine.checkpoint import (
    _state_leaves, load_stream_state, save_stream_state)
from go_audio_resampler_tpu_torch.engine.plan import plan_engine
from go_audio_resampler_tpu_torch.filterdesign import Quality
from go_audio_resampler_tpu_torch.ops import fused
from go_audio_resampler_tpu_torch.ops.precision import default_error_bound

streaming = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.streaming")

TOL = {np.float32: 2e-5, np.float64: 1e-12}
#: (input rate, output rate, quality): CD->DAT, DAT->CD, and a plan whose
#: operator the engine superframes (two periods per frame).
PLANS = [(44100, 48000, 3), (48000, 44100, 3), (44100, 48000, 4)]
#: Integer decimation: the ML-ingest 48k->16k and 96k->48k, HIGH and
#: VERY_HIGH.
DECIM_PLANS = [(48000, 16000, 3), (96000, 48000, 3), (48000, 16000, 4),
               (96000, 48000, 4)]
#: The walk, cubic and dft_up rows of tests/test_engine_core.py's
#: TOPOLOGIES (non-exact up, down and near-unity; both QUICK rows; integer
#: upsampling x2 and x4), and the walk on the hq_interp banks.
WALK_PLANS = [(44100, 48001, 3), (48000, 44099, 3), (44100, 44101, 2),
              (44100, 48001, 3, {"hq_interp": True})]
CUBIC_PLANS = [(44100, 48000, 0), (48000, 44100, 0)]
DFT_PLANS = [(48000, 96000, 3), (48000, 192000, 2)]
BATCH, BLOCK = 3, 512
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engines(rates_q, dtype, batch=BATCH, block=BLOCK):
    """The JAX engine and the port's, on one plan (carried across as
    arrays, so both run the very same filter bank)."""
    jp = jplan_engine(rates_q[0], rates_q[1], JQuality(rates_q[2]),
                      **(rates_q[3] if len(rates_q) > 3 else {}))
    tp = plan_from_arrays({f: getattr(jp, f)
                           for f in jp.__dataclass_fields__})
    return (JEngine(jp, batch=batch, block=block, dtype=dtype),
            EngineCore(tp, batch=batch, block=block, dtype=dtype,
                       device="cpu"))


def _splits(rng, n, max_chunk):
    cuts, at = [], 0
    while at < n:
        step = int(rng.integers(0, max_chunk + 1))
        cuts.append((at, min(n, at + step)))
        at += step
    return cuts


def _close(a, b, dtype):
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates_q", PLANS + DECIM_PLANS + WALK_PLANS
                         + CUBIC_PLANS + DFT_PLANS)
def test_process_flush_random_chunks(rates_q, dtype):
    je, te = _engines(rates_q, dtype)
    assert te.block == je.block and te.get_latency() == je.get_latency()
    rng = np.random.default_rng(11)
    n = 6000                                # > SCAN_BLOCKS blocks in total
    x = rng.normal(size=(BATCH, n)).astype(dtype)
    outs_j, outs_t = [], []
    for a, b in _splits(rng, n, 2500) + [(0, 0)]:
        yj, yt = np.asarray(je.process(x[:, a:b])), te.process(x[:, a:b])
        assert yt.dtype == dtype and yj.shape == yt.shape
        outs_j.append(yj)
        outs_t.append(yt)
    outs_j.append(np.asarray(je.flush()))
    outs_t.append(te.flush())
    yj, yt = np.concatenate(outs_j, 1), np.concatenate(outs_t, 1)
    assert yt.shape[1] == te.plan.lengths.canonical(n)
    _close(yt, yj, dtype)
    assert te.get_statistics() == je.get_statistics()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates_q", PLANS + DECIM_PLANS + DFT_PLANS)
def test_device_mode(rates_q, dtype):
    je, te = _engines(rates_q, dtype)
    mult = te.device_chunk_multiple
    assert mult == je.device_chunk_multiple
    rng = np.random.default_rng(12)
    widths = [3 * mult, 0, mult, 17 * mult, 2 * mult]
    x = rng.normal(size=(BATCH, sum(widths))).astype(dtype)
    outs_j, outs_t, at = [], [], 0
    for w in widths:
        yj = np.asarray(je.process_device(jnp.asarray(x[:, at:at + w])))
        yt = te.process_device(torch.from_numpy(x[:, at:at + w]))
        assert isinstance(yt, torch.Tensor) and yt.device.type == "cpu"
        assert yt.shape == yj.shape
        outs_j.append(yj)
        outs_t.append(yt.numpy())
        at += w
    outs_j.append(np.asarray(je.flush_device()))
    outs_t.append(te.flush_device().numpy())
    yj, yt = np.concatenate(outs_j, 1), np.concatenate(outs_t, 1)
    assert yt.shape[1] == te.plan.lengths.canonical(x.shape[1])
    _close(yt, yj, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates_q", PLANS[:2] + DECIM_PLANS[:1])
def test_start_from_same_nonzero_carry(rates_q, dtype):
    """Past the start-up ramp (whose outputs the engine drops), both
    engines resume from one given carry."""
    je, te = _engines(rates_q, dtype)
    rng = np.random.default_rng(13)
    x0 = np.zeros((BATCH, 2 * te.block), dtype)
    je.process(x0)
    te.process(x0)
    carry = rng.normal(size=tuple(te.state.shape)).astype(dtype)
    assert carry.shape[1] > 0
    je.state = jnp.asarray(carry)
    te.set_carry(carry)
    x = rng.normal(size=(BATCH, 2000)).astype(dtype)
    yj = np.concatenate([np.asarray(je.process(x)),
                         np.asarray(je.flush())], 1)
    yt = np.concatenate([te.process(x), te.flush()], 1)
    _close(yt, yj, dtype)
    # The carry shows in the output: the same run from a zero carry differs.
    te.reset()
    te.process(x0)
    y0 = np.concatenate([te.process(x), te.flush()], 1)
    assert y0.shape == yt.shape and np.abs(y0 - yt).max() > 1e-3
    with pytest.raises(ValueError, match="carry must be"):
        te.set_carry(carry[:, 1:])


@pytest.mark.parametrize("n", [0, 1, 146, 147, 1000, 4703, 4704])
def test_exact_lengths(n):
    je, te = _engines(PLANS[0], np.float64, batch=1)
    x = np.random.default_rng(n).normal(size=n)
    yj = np.concatenate([np.asarray(je.process(x)),
                         np.asarray(je.flush())], 1)
    yt = np.concatenate([te.process(x), te.flush()], 1)
    assert yt.shape == yj.shape == (1, te.plan.lengths.canonical(n))
    _close(yt, yj, np.float64)


@pytest.mark.parametrize("out", ["host", "device"])
def test_stream_generator(out):
    je, te = _engines(PLANS[0], np.float64)
    rng = np.random.default_rng(15)
    chunks = [rng.normal(size=(BATCH, w)) for w in (100, 700, 5, 1500, 33)]
    yj = np.concatenate([np.asarray(y) for y in je.stream(chunks, out=out)],
                        1)
    got = list(te.stream(chunks, out=out))
    assert all(isinstance(y, np.ndarray if out == "host" else torch.Tensor)
               for y in got)
    yt = np.concatenate([np.asarray(y) for y in got], 1)
    assert yt.shape[1] == te.plan.lengths.canonical(sum(c.shape[1]
                                                        for c in chunks))
    _close(yt, yj, np.float64)


def test_chunking_invariance():
    """process() with random splits and process_device() in one chunk give
    the same canonical stream."""
    rates_q, dtype = PLANS[0], np.float64
    x = np.random.default_rng(16).normal(size=(BATCH, 147 * 40))
    _, a = _engines(rates_q, dtype)
    rng = np.random.default_rng(17)
    ya = np.concatenate([a.process(x[:, i:j])
                         for i, j in _splits(rng, x.shape[1], 900)]
                        + [a.flush()], 1)
    _, b = _engines(rates_q, dtype)
    yb = torch.cat([b.process_device(torch.from_numpy(x)),
                    b.flush_device()], 1).numpy()
    _close(ya, yb, dtype)


#: name -> the widths of successive process() calls, given the engine's
#: block b: whole blocks into an empty FIFO, chunks that keep the FIFO
#: filled, more whole blocks in one call than SCAN_BLOCKS, and a mix.
CHUNKINGS = {
    "whole_blocks": lambda b: [b, 2 * b, b, 3 * b],
    "block_minus_1": lambda b: [b - 1] * 7,
    "one_sample": lambda b: [1] * (b + 3),
    "three_blocks_and_7": lambda b: [3 * b + 7] * 3,
    "past_scan_blocks": lambda b: [(EngineCore.SCAN_BLOCKS + 3) * b + 5,
                                   2 * b - 5, b],
    "mix": lambda b: [b, 5, b - 5, 2 * b, 1, 0, 3 * b + 7, b - 8, 4 * b],
}


def _bypassed_blocks(widths, block):
    """The whole blocks of the calls that find the input FIFO empty."""
    fill, n = 0, 0
    for w in widths:
        if not fill:
            n += w // block
        fill = (fill + w) % block
    return n


def _run_widths(te, x, widths, start=0, save_at=None):
    """process() over ``widths`` of ``x`` from ``start``, then flush();
    returns the outputs and, where ``save_at`` is a path, the number of
    calls up to the first that bypassed the FIFO, with the engine's state
    saved there after it."""
    outs, at, saved = [], start, None
    for i, w in enumerate(widths):
        before = streaming.fifo_bypass_blocks
        outs.append(te.process(x[:, at:at + w]))
        at += w
        if (save_at is not None and saved is None
                and streaming.fifo_bypass_blocks > before):
            save_stream_state(te, save_at)
            saved = i + 1
    outs.append(te.flush())
    return outs, saved


@pytest.mark.parametrize("rates_q", [PLANS[0], WALK_PLANS[0]],
                         ids=["banded", "walk"])
@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_process_returns_new_arrays_past_the_fifo(chunking, rates_q,
                                                  tmp_path):
    """process() and flush() over chunkings that go past the input FIFO,
    through it, and both: the stream is the JAX engine's; every returned
    array is new, shares no memory with the engine or another output, and
    stays as it was through later process, flush and reset calls;
    ``fifo_bypass_blocks`` counts the whole blocks of the calls that find
    the FIFO empty; a checkpoint saved after a bypassed step resumes in a
    new engine bit for bit."""
    dtype = np.float64
    je, te = _engines(rates_q, dtype)
    widths = CHUNKINGS[chunking](te.block)
    x = np.random.default_rng(14).normal(
        size=(BATCH, sum(widths))).astype(dtype)
    streaming.fifo_bypass_blocks = 0
    outs, saved = _run_widths(te, x, widths, save_at=tmp_path / "s.npz")
    assert streaming.fifo_bypass_blocks == _bypassed_blocks(widths, te.block)
    assert (saved is None) == (_bypassed_blocks(widths, te.block) == 0)
    yj, at = [], 0
    for w in widths:
        yj.append(np.asarray(je.process(x[:, at:at + w])))
        at += w
    yj.append(np.asarray(je.flush()))
    _close(np.concatenate(outs, 1), np.concatenate(yj, 1), dtype)

    engine_memory = [te._pending._buf] + [
        b.numpy() for b in (te._stage_in, te._stage_out) if b is not None
    ] + [leaf.numpy() for leaf in _state_leaves(te.state)
         if isinstance(leaf, torch.Tensor)]
    for i, y in enumerate(outs):
        assert not any(np.shares_memory(y, m) for m in engine_memory)
        assert not any(np.shares_memory(y, o) for o in outs[:i])
    kept = [y.copy() for y in outs]
    # Later calls on reversed views of x, whose negative strides the
    # bypass copies from as they are: each view's stream is its
    # contiguous copy's, and the outputs above stay as they were.
    for view in (x[:, ::-1], x[::-1]):
        te.reset()
        got, _ = _run_widths(te, view, widths)
        te.reset()
        want, _ = _run_widths(te, view.copy(), widths)
        assert np.array_equal(np.concatenate(got, 1),
                              np.concatenate(want, 1))
    te.reset()
    assert all(np.array_equal(y, k) for y, k in zip(outs, kept))

    if saved is not None:
        fresh = EngineCore(te.plan, batch=BATCH, block=BLOCK,
                           dtype=torch.float64, device="cpu")
        load_stream_state(fresh, tmp_path / "s.npz")
        rest, _ = _run_widths(fresh, x, widths[saved:],
                              start=sum(widths[:saved]))
        assert np.array_equal(np.concatenate(rest, 1),
                              np.concatenate(outs[saved:], 1))


def test_reset_and_flush_rules():
    _, te = _engines(PLANS[0], np.float64)
    x = np.random.default_rng(18).normal(size=(BATCH, 3000))
    y1 = np.concatenate([te.process(x), te.flush()], 1)
    assert te.flush().shape == (BATCH, 0)
    with pytest.raises(RuntimeError, match="after flush"):
        te.process(x)
    with pytest.raises(RuntimeError, match="after flush"):
        te.process_device(torch.zeros((BATCH, 147), dtype=torch.float64))
    te.reset()
    y2 = np.concatenate([te.process(x), te.flush()], 1)
    assert np.array_equal(y1, y2)
    te.reset()
    te.process(x[:, :100])                   # leaves host input buffered
    with pytest.raises(RuntimeError, match="host-buffered"):
        te.process_device(torch.zeros((BATCH, 147), dtype=torch.float64))
    te.reset()
    with pytest.raises(ValueError, match="not a multiple"):
        te.process_device(torch.zeros((BATCH, 100), dtype=torch.float64))
    with pytest.raises(ValueError, match="expected 3 streams"):
        te.process(np.zeros((2, 10)))


def test_mono_input_broadcasts():
    je, te = _engines(PLANS[0], np.float64)
    x = np.random.default_rng(19).normal(size=2000)
    yj = np.concatenate([np.asarray(je.process(x)),
                         np.asarray(je.flush())], 1)
    yt = np.concatenate([te.process(x), te.flush()], 1)
    _close(yt, yj, np.float64)
    assert np.array_equal(yt[0], yt[2])


@pytest.mark.parametrize("batch", [1, BATCH])
def test_reversed_mono_input(batch):
    """A reversed 1-D view (a negative stride; read-only once broadcast
    over streams) of whole blocks gives the stream of its contiguous
    copy."""
    _, te = _engines(PLANS[0], np.float64, batch=batch)
    x = np.random.default_rng(20).normal(size=3 * te.block)[::-1]
    streaming.fifo_bypass_blocks = 0
    got = np.concatenate([te.process(x), te.flush()], 1)
    assert streaming.fifo_bypass_blocks == 3
    te.reset()
    want = np.concatenate([te.process(x.copy()), te.flush()], 1)
    assert np.array_equal(got, want)


def test_introspection_matches():
    je, te = _engines(PLANS[1], np.float32)
    assert te.get_ratio() == je.get_ratio()
    assert te.get_latency() == je.get_latency()
    assert te.estimate_output(44100) == je.estimate_output(44100)
    assert te._flush_limit == je._flush_extra_limit()
    assert te._period == je._device_params()
    assert te.get_statistics() == {"samplesIn": 0, "samplesOut": 0}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates_q", DECIM_PLANS)
def test_decimation_at_block_2048_matches_jax(rates_q, dtype):
    """At the default block the decimation operator is superframed; the
    port's constants equal the JAX engine's, and so does the stream."""
    je, te = _engines(rates_q, dtype, block=2048)
    assert (te.block, te._band.carry, te._drop) == (
        je.block, je._decim_carry, je._drop_override)
    assert te._period == je._device_params()
    assert te._flush_limit == je._flush_extra_limit()
    assert np.array_equal(te._band.r_t.numpy(), np.asarray(je._decim_rt))
    rng = np.random.default_rng(14)
    x = rng.normal(size=(BATCH, 8000)).astype(dtype)
    yj = np.concatenate([np.asarray(je.process(x[:, :3333])),
                         np.asarray(je.process(x[:, 3333:])),
                         np.asarray(je.flush())], 1)
    yt = np.concatenate([te.process(x[:, :3333]), te.process(x[:, 3333:]),
                         te.flush()], 1)
    assert yt.shape[1] == te.plan.lengths.canonical(8000)
    _close(yt, yj, dtype)


def test_decimation_geometry_48k_16k():
    """48k -> 16k HIGH: T = 1349 taps, R [256, 2114] over Ipx 768; the
    superframe makes it [512, 2882] over 1536, the block 3072."""
    _, te = _engines(DECIM_PLANS[0], np.float32, block=2048)
    assert te.plan.decim_taps == 1349
    assert tuple(te._band.r_t.shape) == (2882, 512)
    assert te._band[1:4] == (1536, 2882, 512)
    assert te.block == 3072 and te.device_chunk_multiple == 1536
    assert (te._band.carry, te._drop) == (1350, 450)


def test_fft_decimation_raises(monkeypatch):
    """Decimation at DECIM_FFT_MIN_TAPS taps or more streams through FFT
    overlap-save: with both crossovers lowered, the port's engine agrees
    with the JAX engine's FFT route to 1e-11 (the FFT routes' float64
    tolerance), with equal lengths."""
    monkeypatch.setattr(streaming, "DECIM_FFT_MIN_TAPS", 1)
    monkeypatch.setattr(importlib.import_module(
        "go_audio_resampler_tpu.engine.oneshot"), "DECIM_FFT_MIN_TAPS", 1)
    je, te = _engines(DECIM_PLANS[0], np.float64)
    assert je._decim_fft and te._decim_fft is not None
    x = np.random.default_rng(13).normal(size=(BATCH, 6000))
    yj = np.concatenate([je.process(x), je.flush()], axis=1)
    yt = np.concatenate([te.process(x), te.flush()], axis=1)
    assert yt.shape == yj.shape == (BATCH, te.plan.lengths.canonical(6000))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-11)


def test_process_steps_through_the_fused_wrapper(monkeypatch):
    """Every step of the engine goes through ops.fused.fused_resample."""
    calls = []
    real = fused.fused_resample

    def spy(data, r_t, **kw):
        calls.append((tuple(data.shape), tuple(kw["head"].shape),
                      kw["n_frames"]))
        return real(data, r_t, **kw)

    monkeypatch.setattr(fused, "fused_resample", spy)
    _, te = _engines(PLANS[0], np.float32)
    te.process(np.zeros((BATCH, 9 * te.block), np.float32))
    te.flush()
    nf = te.block // 147
    carry = (BATCH, te._band.carry)
    assert calls[0] == ((BATCH, 8 * te.block), carry, 8 * nf)
    assert calls[1] == ((BATCH, te.block), carry, nf)


@pytest.mark.parametrize("frames", [1, 2, 8])
def test_fused_banded_step_reads_carry_and_block_in_place(monkeypatch,
                                                          frames):
    """The step hands K1 the block itself and the carry as its head (the
    same storage, no ``torch.cat``), and its new carry equals the parent
    formula ``cat([carry, x])[:, b:]``, for blocks shorter than the carry
    (one frame), as long as it (two) and longer, in a copy of its own laid
    out for K1's 16-byte copies beside a block like ``x``: each row C
    floats before the block's row modulo 4, the rows the block's stride
    apart modulo 4."""
    _, te = _engines(PLANS[0], np.float32)
    r_t, ipx, wx, p2, c, op = te._band
    b = frames * ipx
    rng = np.random.default_rng(frames)
    carry = torch.from_numpy(rng.normal(size=(BATCH, c)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(BATCH, b)).astype(np.float32))
    assert (c, b < c, b == c) == (294, frames == 1, frames == 2)
    seen, real = [], fused.fused_resample

    def spy(data, r, **kw):
        seen.append((data, kw["head"]))
        return real(data, r, **kw)

    monkeypatch.setattr(fused, "fused_resample", spy)
    new, y, n = streaming._fused_banded_step(r_t, carry, x, ipx=ipx, wx=wx,
                                             p2=p2, op=op, tier="highest")
    assert len(seen) == 1 and seen[0][0] is x and seen[0][1] is carry
    joined = torch.cat([carry, x], dim=1)
    assert torch.equal(new, joined[:, b:]) and new.stride(1) == 1
    assert (new.data_ptr() - x.data_ptr()) // 4 % 4 == -c % 4
    assert (new.stride(0) - x.stride(0)) % 4 == 0
    want = fused.fused_resample_reference(joined, r_t, ipx=ipx, wx=wx, p2=p2,
                                          n_frames=frames, tier="highest")
    assert n == frames * p2 and torch.equal(y, want)
    x.zero_()
    carry.zero_()
    assert torch.equal(new, joined[:, b:])


# -- guards --------------------------------------------------------------------

def test_port_imports_no_jax():
    code = ("import sys, go_audio_resampler_tpu_torch as g\n"
            "import go_audio_resampler_tpu_torch.engine.streaming\n"
            "import go_audio_resampler_tpu_torch.ops.fused\n"
            "import go_audio_resampler_tpu_torch.ops.tmajor\n"
            "import go_audio_resampler_tpu_torch.ops.general\n"
            "import go_audio_resampler_tpu_torch.ops.convolve\n"
            "import go_audio_resampler_tpu_torch.engine.tmajor\n"
            "import go_audio_resampler_tpu_torch.engine.oneshot\n"
            "import go_audio_resampler_tpu_torch.pipeline.fused\n"
            "import go_audio_resampler_tpu_torch.pipeline.planner\n"
            "import go_audio_resampler_tpu_torch.engine.fftstage\n"
            "import go_audio_resampler_tpu_torch.api\n"
            "import go_audio_resampler_tpu_torch.convenience\n"
            "import go_audio_resampler_tpu_torch.utils\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == "
            "'go_audio_resampler_tpu' or "
            "m.startswith('go_audio_resampler_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ops_do_not_import_the_engine():
    """The kernel layer depends on nothing above it: no module of
    ``ops`` imports from ``engine``."""
    ops_dir = os.path.join(REPO, "go_audio_resampler_tpu_torch", "ops")
    for name in sorted(os.listdir(ops_dir)):
        if name.endswith(".py"):
            with open(os.path.join(ops_dir, name)) as f:
                src = f.read()
            assert "..engine" not in src and "_torch.engine" not in src, name


def test_jax_package_settings_do_not_reach_the_port():
    """The JAX package reads its FFT-decimation crossover and its matrix
    cache size from the environment; the port keeps both fixed, so a
    crossover set for the JAX package does not move the port's
    decimation off K1."""
    code = ("import importlib, go_audio_resampler_tpu_torch as g\n"
            "o = importlib.import_module("
            "'go_audio_resampler_tpu_torch.engine.oneshot')\n"
            "assert o.DECIM_FFT_MIN_TAPS == 16384, o.DECIM_FFT_MIN_TAPS\n"
            "assert o.GENERAL_CACHE_LIMIT == 512 << 20\n"
            "p = g.plan_engine(48000, 16000, g.Quality.HIGH)\n"
            "assert p.decim_taps == 1349\n"
            "g.EngineCore(p, device='cpu')\n"
            "g.TimeMajorEngine(p, device='cpu')\n"
            "g.oneshot(p, [[0.0] * 100], device='cpu')\n")
    env = dict(os.environ, PYTHONPATH=REPO, GAR_DECIM_FFT_MIN_TAPS="1024",
               GAR_TPU_MATRIX_CACHE_MB="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_exports():
    assert {"plan_engine", "EngineCore", "TimeMajorEngine", "oneshot",
            "Quality", "Config", "new_resampler", "resample_mono",
            "new_engine_float32"} <= set(gart.__all__)
    assert gart.Quality is Quality is gart.EngineQuality
    assert callable(gart.oneshot) and gart.oneshot.__module__ == (
        "go_audio_resampler_tpu_torch.engine.oneshot")


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineCore(plan_engine(44100, 48000, Quality.HIGH))


@pytest.mark.parametrize("rates,kw", [
    ((48000, 44101, 3), {"strict_antialias": True}),  # the walk's
    ((48000, 44099, 3), {"strict_antialias": True}),  # the walk's
])
def test_unported_topologies_raise(rates, kw, monkeypatch):
    """The walk's prefilter at FFT_CONV_MIN_TAPS taps or more runs through
    FFT overlap-save (``_fir_fft_step``): with both crossovers lowered to
    this plan's taps, the port's walk agrees with the JAX walk to 1e-11."""
    jp = jplan_engine(*rates[:2], JQuality(rates[2]), **kw)
    tp = plan_from_arrays({f: getattr(jp, f)
                           for f in jp.__dataclass_fields__})
    monkeypatch.setattr(streaming, "FFT_CONV_MIN_TAPS", tp.aa_taps)
    monkeypatch.setattr(importlib.import_module(
        "go_audio_resampler_tpu.engine.oneshot"), "FFT_CONV_MIN_TAPS",
        tp.aa_taps)
    je = JEngine(jp, batch=BATCH, block=BLOCK, dtype=np.float64)
    te = EngineCore(tp, batch=BATCH, block=BLOCK, dtype=np.float64,
                    device="cpu")
    assert te._aa_spec is not None
    x = np.random.default_rng(14).normal(size=(BATCH, 4000))
    yj = np.concatenate([je.process(x), je.flush()], axis=1)
    yt = np.concatenate([te.process(x), te.flush()], axis=1)
    assert yt.shape == yj.shape == (BATCH, tp.lengths.canonical(4000))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-11)


@pytest.mark.parametrize("kw,exc", [
    ({"precision": "tune"}, ValueError),
    ({"dispatch": "bogus"}, ValueError),
    ({"precision": "bogus"}, ValueError),
    ({"dtype": np.int32}, ValueError),
])
def test_unsupported_knobs_raise(kw, exc):
    plan = plan_engine(44100, 48000, Quality.HIGH)
    with pytest.raises(exc):
        EngineCore(plan, device="cpu", **kw)


@pytest.mark.parametrize("kw", [{"dispatch": "pallas"}, {"dispatch": "xla"},
                                {"dispatch": "tune"},
                                {"precision": "high"},
                                {"precision": "default"}])
def test_ported_knobs_run(kw):
    """The dispatch modes and reduced tiers run and match the JAX engine:
    every mode gives the default engine's bits (on the CPU each takes the
    plain version; 'tune' resolves to 'auto' off the card, as the JAX
    engine's does off the TPU) within 2e-5 of JAX's float32 run with the
    same mode;
    'high' is within 3e-4 of max|y| of JAX's float64 run and 'default'
    within a bound from bf16's roundoff
    (``precision.default_error_bound``)."""
    rates_q = (44100, 48000, 3)
    x = np.random.default_rng(14).normal(size=(BATCH, 4000)).astype(
        np.float32)
    je, te = _engines(rates_q, np.float32)
    te = EngineCore(te.plan, batch=BATCH, block=BLOCK, dtype=np.float32,
                    device="cpu", **kw)
    got = np.concatenate([te.process(x), te.flush()], axis=1)
    if "dispatch" in kw:
        je = JEngine(je.plan, batch=BATCH, block=BLOCK, dtype=np.float32,
                     dispatch=kw["dispatch"])
        assert te.dispatch == je.dispatch == (
            "auto" if kw["dispatch"] == "tune" else kw["dispatch"])
        want = np.concatenate([np.asarray(je.process(x)),
                               np.asarray(je.flush())], axis=1)
        _close(got, want, np.float32)
        ref = EngineCore(te.plan, batch=BATCH, block=BLOCK,
                         dtype=np.float32, device="cpu")
        assert np.array_equal(got, np.concatenate([ref.process(x),
                                                   ref.flush()], axis=1))
        return
    assert te.precision == kw["precision"]
    je, _ = _engines(rates_q, np.float64)
    want = np.concatenate([np.asarray(je.process(x.astype(np.float64))),
                           np.asarray(je.flush())], axis=1)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if kw["precision"] == "high":
        bound = 3e-4 * np.abs(want).max()
    else:
        bound = default_error_bound(np.abs(x).max(), te._band.r_t)
    assert err <= bound, (err, bound)
    exact = EngineCore(te.plan, batch=BATCH, block=BLOCK, dtype=np.float32,
                       device="cpu")
    assert np.abs(np.concatenate([exact.process(x), exact.flush()], axis=1)
                  - want).max() < err


@pytest.mark.parametrize("precision", ["auto", "highest"])
def test_supported_precisions(precision):
    e = EngineCore(plan_engine(44100, 48000, Quality.HIGH), device="cpu",
                   precision=precision, dtype=torch.float64)
    assert e.dtype == torch.float64 and e.np_dtype == np.float64


# -- the general walk, cubic and dft_up -----------------------------------------

@pytest.mark.parametrize("rates_q", WALK_PLANS + CUBIC_PLANS + DFT_PLANS)
def test_walk_cubic_dft_up_constants_match_jax(rates_q):
    """The block after the walks' halving loops, the output caps, the
    history sizes, the device granule, the flush bound and latency."""
    je, te = _engines(rates_q, np.float32, block=2048)
    for name in ("block", "poly_cap", "poly_keep", "hist_size",
                 "cubic_cap"):
        assert getattr(te, name, None) == getattr(je, name, None), name
    assert te.device_chunk_multiple == je.device_chunk_multiple
    assert te._flush_limit == je._flush_extra_limit()
    assert te.get_latency() == je.get_latency()
    # The JAX engine falls back to the length model's transient prefix.
    assert je._drop_override is None
    assert te._drop == je.plan.lengths.drop_prefix()
    if te.plan.kind == "dft_up":
        assert te._period == je._device_params() == (1, te.plan.factor)
    else:
        assert te.device_chunk_multiple is None and te._period is None


@pytest.mark.parametrize("rates_q", [WALK_PLANS[0], WALK_PLANS[1],
                                     CUBIC_PLANS[0], DFT_PLANS[0]])
def test_walk_cubic_dft_up_chunking_and_block_invariance(rates_q):
    """Random chunk splits at block 512, one whole chunk at blocks 1000
    and 4096: one canonical stream."""
    x = np.random.default_rng(20).normal(size=(BATCH, 7000))
    _, a = _engines(rates_q, np.float64)
    rng = np.random.default_rng(21)
    ya = np.concatenate([a.process(x[:, i:j])
                         for i, j in _splits(rng, x.shape[1], 1500)]
                        + [a.flush()], 1)
    assert ya.shape[1] == a.plan.lengths.canonical(x.shape[1])
    for block in (1000, 4096):
        b = EngineCore(a.plan, batch=BATCH, block=block, dtype=np.float64,
                       device="cpu")
        assert b.block == block
        _close(np.concatenate([b.process(x), b.flush()], 1), ya,
               np.float64)


@pytest.mark.parametrize("rates_q", [WALK_PLANS[0], CUBIC_PLANS[1]])
def test_data_dependent_topologies_stream_on_the_host(rates_q):
    """The walk and cubic have no static output counts: ``stream`` falls
    back to process()/flush() on the host, the device modes raise."""
    je, te = _engines(rates_q, np.float64)
    assert te.device_chunk_multiple is None
    chunks = [np.random.default_rng(22).normal(size=(BATCH, w))
              for w in (100, 700, 5, 1500, 33)]
    yj = np.concatenate([np.asarray(y) for y in je.stream(chunks)], 1)
    got = list(te.stream(chunks))
    assert all(isinstance(y, np.ndarray) for y in got)
    _close(np.concatenate(got, 1), yj, np.float64)
    te.reset()
    z = torch.zeros((BATCH, 64), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="process_device: topology"
                       ".*data-dependent output counts; use process"):
        te.process_device(z)
    with pytest.raises(NotImplementedError, match="flush_device: topology"
                       ".*data-dependent output counts; use flush"):
        te.flush_device()
    with pytest.raises(NotImplementedError, match="stream.out='device'.: "
                       "topology .*; use out='host'"):
        list(te.stream(chunks, out="device"))
    with pytest.raises(NotImplementedError, match="not one carry"):
        te.set_carry(np.zeros((BATCH, 3)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates_q", DFT_PLANS)
def test_dft_up_process_device_equals_process(rates_q, dtype):
    """dft_up streams with static counts: process_device/flush_device in
    chunks of any width equal process()/flush() with random splits."""
    x = np.random.default_rng(23).normal(size=(BATCH, 3000)).astype(dtype)
    _, a = _engines(rates_q, dtype)
    _, b = _engines(rates_q, dtype)
    rng = np.random.default_rng(24)
    ya = np.concatenate([a.process(x[:, i:j])
                         for i, j in _splits(rng, 3000, 900)]
                        + [a.flush()], 1)
    yb = torch.cat([b.process_device(torch.from_numpy(x[:, i:j]))
                    for i, j in ((0, 1024), (1024, 1031), (1031, 3000))]
                   + [b.flush_device()], 1).numpy()
    assert ya.shape == yb.shape == (BATCH, a.plan.lengths.canonical(3000))
    _close(yb, ya, dtype)


def test_dft_up_factor_one_passes_through():
    te = EngineCore(plan_engine(48000, 48000, Quality.HIGH), batch=2,
                    block=256, dtype=np.float64, device="cpu")
    assert te.plan.kind == "dft_up" and te.plan.factor == 1
    x = np.random.default_rng(25).normal(size=(2, 1000))
    y = np.concatenate([te.process(x[:, :300]), te.process(x[:, 300:]),
                        te.flush()], 1)
    assert np.array_equal(y, x)
    te.reset()
    yd = torch.cat([te.process_device(torch.from_numpy(x)),
                    te.flush_device()], 1)
    assert np.array_equal(yd.numpy(), x)


def _walk_default_bound(x_abs_max: float, plan) -> float:
    """``precision.default_error_bound`` of the walk's two products: the
    prestage's own, carried through the emit's coefficients, plus the
    emit's on the prestage's output (|u| <= max|x| * the prestage's L1
    norm; an interpolated coefficient row is at most |A|+|B|+|C|+|D|)."""
    pre = np.asarray(plan.pre_coeffs).T                     # [T1, F]
    rows = sum(np.abs(np.asarray(b)) for b in (
        plan.bank_a, plan.bank_b, plan.bank_c, plan.bank_d)).T  # [T2, L]
    l1_pre = float(np.abs(pre).sum(axis=0).max())
    l1_poly = float(rows.sum(axis=0).max())
    return (default_error_bound(x_abs_max, pre) * l1_poly
            + default_error_bound(x_abs_max * l1_pre, rows))


@pytest.mark.parametrize("precision", ["high", "default"])
def test_walk_at_reduced_tiers(precision):
    """The walk at 'high' within 3e-4 of max|y| of JAX's float64 run, at
    'default' within bf16's roundoff bound; 'highest' is closer."""
    rates_q = WALK_PLANS[0]
    x = np.random.default_rng(26).normal(size=(BATCH, 4000)).astype(
        np.float32)
    je, te = _engines(rates_q, np.float64)
    want = np.concatenate([np.asarray(je.process(x.astype(np.float64))),
                           np.asarray(je.flush())], axis=1)
    runs = {}
    for tier in (precision, "highest"):
        e = EngineCore(te.plan, batch=BATCH, block=BLOCK, dtype=np.float32,
                       device="cpu", precision=tier)
        runs[tier] = np.concatenate([e.process(x), e.flush()], axis=1)
        assert runs[tier].shape == want.shape
    err = np.abs(runs[precision] - want).max()
    if precision == "high":
        bound = 3e-4 * np.abs(want).max()
    else:
        bound = _walk_default_bound(float(np.abs(x).max()), te.plan)
    assert err <= bound, (err, bound)
    assert np.abs(runs["highest"] - want).max() < err


def test_walk_block_guard():
    """A walk whose single input sample would emit more than the walks'
    bound raises, where the JAX engine's halving loop has no floor."""
    src = plan_engine(44100, 48001, Quality.HIGH)      # a cached plan
    plan = plan_from_arrays({f: getattr(src, f)
                             for f in src.__dataclass_fields__})
    plan.step = 1
    with pytest.raises(ValueError, match="no block fits"):
        EngineCore(plan, device="cpu")
