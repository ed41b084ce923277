"""Streaming engine: stateful Process/Flush over fixed-size blocks.

PyTorch counterpart of the JAX package's ``engine/streaming.py``.  Two
topologies are ported, both streaming one periodic banded operator
through the fused banded step, i.e. the K1 kernel (``ops/fused.py``) on
the card: exact-rational two-stage plans (e.g. 44.1k <-> 48k), and
integer decimation (e.g. 48k -> 16k, the ML-ingest path).

The device side is one plain function ``(carry, block) -> (carry', y, n)``
with static output counts; the host wrapper feeds whole blocks from an
input FIFO, so arbitrary chunk sizes stream through it.  Each output
sample is one fixed-order dot product over the input, so the emitted
stream depends only on the concatenated input, not on how it was chunked.

Each engine runs its products at one matmul tier (``precision``,
resolved once when it is built; ``ops/precision.py``) and routes each step
through the dispatch gate (``dispatch``): the kernel, or its plain
version.

Flush follows the reference's orchestration (resampler.go:275-322) via
the length model: the engine feeds the zero padding that drains every
stage, then trims the total stream to the canonical output count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import banded, fused
from ..ops.precision import (DISPATCH_MODES, PRECISION_MODES, dispatch_for,
                             dot_precision)
from ..pipeline.buffer import SampleFIFO
from .oneshot import (DECIM_FFT_MIN_TAPS, _FFT_DECIM, _decim_matrix,
                      _fused_rational_matrix, superframe)
from .plan import EnginePlan

#: The JAX engine's measured choice of lowering, not ported yet.
_TUNE = ("dispatch='tune' is not ported yet (ROADMAP.md, queue 1: "
         "\"dispatch='tune'\")")


def _check_knobs(dispatch: str, precision: str) -> str:
    """``dispatch`` and ``precision`` checked as the JAX engine checks
    them; returns the engine's tier (:func:`dot_precision` of
    ``precision``, 'auto' read from the process-wide tier now)."""
    if dispatch == 'tune':
        raise NotImplementedError(_TUNE)
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, got "
                         f"{dispatch!r}")
    if precision not in PRECISION_MODES:
        raise ValueError(f"precision must be one of {PRECISION_MODES}, got "
                         f"{precision!r}")
    return dot_precision(precision)


class Band(NamedTuple):
    """The fused banded step's operator: R_t [wx, p2] on the engine's
    device, its input period ipx, the carry length, and on the card R_t
    as the kernels read it at the engine's tier (``banded.prepare``; None
    on the CPU)."""
    r_t: torch.Tensor
    ipx: int
    wx: int
    p2: int
    carry: int
    op: banded.BandedOperator | None = None


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")


def _banded_frames_apply(data: torch.Tensor, r_t: torch.Tensor, ipx: int,
                         wx: int, p2: int, n_frames: int,
                         op: banded.BandedOperator | None = None,
                         dispatch: str = 'auto', *,
                         tier: str) -> torch.Tensor:
    """Windows at j*ipx of width wx times r_t [wx, p2] -> [S, F*p2], at
    ``tier``.

    Where the gate lets ``dispatch`` through (``precision.dispatch_for``),
    the K1 kernel on a CUDA tensor (reading ``op``) and its plain version
    on a CPU tensor; else the plain version on either.
    """
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=n_frames, tier=tier)
    if dispatch_for(dispatch, tier):
        return fused.fused_resample(data, r_t, op=op, **kw)
    return fused.fused_resample_reference(data, r_t, **kw)


def _fused_banded_step(r_t, carry, x, ipx, wx, p2, op=None,
                       dispatch='auto', *, tier):
    """The streaming step of the fused banded topologies (the JAX
    package's ``_step_rational_fused`` and ``_step_decim_fused``).

    Frames period-aligned windows of [carry ++ block] and applies the
    per-period matrix; with the block a multiple of the input period
    ``ipx``, every step emits exactly (B/ipx)*p2 samples.  The leading
    outputs of the stream are the zero-carry ramp, which the wrapper
    drops.  Returns ``(carry', y, n_valid)``; the new carry is a
    contiguous copy, so the step's input can be freed.
    """
    b = x.shape[1]
    n_frames = b // ipx
    data = torch.cat([carry.to(x.dtype), x], dim=1)
    y = _banded_frames_apply(data, r_t, ipx, wx, p2, n_frames, op, dispatch,
                             tier=tier)
    return data[:, b:].contiguous(), y, n_frames * p2


def pipelined_stream(eng, chunks, out: str, granule: int):
    """Pipelined-stream protocol behind :meth:`EngineCore.stream`.

    Input chunks of any widths are carved into ``granule`` multiples; the
    download of chunk k is deferred until chunk k+1 has been queued (CUDA
    work is asynchronous), so the copy back rides under compute.  A
    sub-granule remainder goes through the host ``process`` path; anything
    it emits is yielded in order, and ``flush_device`` folds the rest into
    the tail.
    """
    if out not in ('host', 'device'):
        raise ValueError(f"out must be 'host' or 'device', got {out!r}")

    def _norm(x) -> np.ndarray:
        x = np.asarray(x, dtype=eng.np_dtype)
        if x.ndim == 1:
            x = (np.broadcast_to(x, (eng.batch, x.shape[0]))
                 if eng.batch > 1 else x[None, :])
        return x

    def _pop(pend):
        return pend.cpu().numpy() if out == 'host' else pend

    pend = None                              # queued, not downloaded
    buf = np.zeros((eng.batch, 0), eng.np_dtype)
    for x in chunks:
        buf = np.concatenate([buf, _norm(x)], axis=1)
        n = (buf.shape[1] // granule) * granule
        if not n:
            continue
        y = eng.process_device(torch.from_numpy(buf[:, :n]))
        buf = buf[:, n:]
        if pend is not None and pend.shape[1]:
            yield _pop(pend)                 # overlaps y's device work
        pend = y
    if buf.shape[1]:
        got = eng.process(buf)
        if got.shape[1]:
            if pend is not None and pend.shape[1]:
                yield _pop(pend)
            pend = (torch.from_numpy(got).to(eng.device) if out == 'device'
                    else torch.from_numpy(got))
    tail = eng.flush_device()
    if pend is not None and pend.shape[1]:
        yield _pop(pend)
    if tail.shape[1]:
        yield _pop(tail)


class EngineCore:
    """Stateful streaming resampler over a batch of independent streams.

    The reference processes channels with one goroutine each
    (constant.go:224-241); here all ``batch`` streams ride the leading
    tensor axis through one kernel launch per step.

    Parameters:
      plan:   built engine plan (filters + topology); the port runs
              exact-rational two-stage plans and integer decimation
      batch:  number of parallel streams S
      block:  internal micro-block size B (input samples per step), rounded
              up to a multiple of the operator's input period
      dtype:  compute dtype: float32 (the only type the CUDA kernel takes)
              or float64 (CPU parity runs)
      dispatch: 'auto' or 'pallas' (the K1 kernel on CUDA, its plain
              version on the CPU), or 'xla' (the plain version on either);
              'tune' is not ported
      precision: the matmul tier of float32 steps: 'highest' (float32-
              accurate), 'high' (three bf16 passes), 'default' (one bf16
              pass), or 'auto' (GAR_TPU_MATMUL_PRECISION, read when the
              engine is built; ``ops/precision.py``).  float64 is exact at
              every tier.
      device: where the engine's tensors live; 'cuda' by default.  Without
              a GPU the default raises; pass device='cpu' to run the plain
              version on the CPU.
    """

    #: blocks per step when process() has many buffered blocks; one launch
    #: then covers them all (bit-identical to block-by-block steps)
    SCAN_BLOCKS = 8

    def __init__(self, plan: EnginePlan, batch: int = 1, block: int = 2048,
                 dtype=torch.float32, dispatch: str = 'auto',
                 precision: str = 'auto', device='cuda'):
        tier = _check_knobs(dispatch, precision)
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                "EngineCore: CUDA is not available; pass device='cpu' to run "
                "on the CPU")
        self.dtype = _torch_dtype(dtype)
        if self.device.type == 'cuda' and self.dtype != torch.float32:
            raise ValueError("EngineCore: the CUDA kernel takes float32; "
                             "float64 runs on device='cpu'")
        self.np_dtype = np.dtype(str(self.dtype).removeprefix('torch.'))
        self.plan = plan
        self.batch = batch
        self.block = block
        self.dispatch = dispatch
        self.precision = precision
        self._tier = tier
        self._build_constants()
        self.reset()

    # -- construction ------------------------------------------------------

    def _build_constants(self):
        p = self.plan
        if p.kind == 'decimate':
            if p.decim_taps >= DECIM_FFT_MIN_TAPS:
                raise NotImplementedError(f"EngineCore: {_FFT_DECIM}")
            r, _, ipx = _decim_matrix(p)
        elif p.kind == 'two_stage' and p.is_rational_exact:
            # Fused streaming: the whole cascade as one periodic banded
            # matmul (oneshot._fused_rational_matrix).
            r, _, ipx, lam = _fused_rational_matrix(p)
        else:
            where = {
                'cubic': "queue 1 item 1, the cubic topology",
                'dft_up': "queue 1 item 1, the dft_up topology",
                'banded': "queue 1 item 3, the banded composite",
                'two_stage': "queue 1 item 1, the non-exact two-stage walk",
            }.get(p.kind, "queue 1")
            raise NotImplementedError(
                f"EngineCore: topology {p.kind!r} is not ported yet "
                f"(ROADMAP.md, {where})")
        # Bound the per-block frames-overlap read amplification; the
        # super-period is capped near the requested block so streaming
        # latency stays at the caller's scale.
        r, ipx = superframe(r, ipx, kf_cap=max(1, self.block // ipx))
        p2, wx = r.shape
        self.block = _ceil_div(self.block, ipx) * ipx
        if p.kind == 'decimate':
            # Canonical window j reads x[j*M : j*M+T] (no zero samples); a
            # zero carry of C = round_up(T-1, M) shifts the local grid by
            # C/M ramp outputs, which the wrapper drops.
            carry = _ceil_div(p.decim_taps - 1, p.factor) * p.factor
            self._drop_override = carry // p.factor
        else:
            # The zero carry C >= Wx-Ipx with C == lam (mod Ipx) places the
            # canonical grid (C-lam)/Ipx periods into the core stream; the
            # wrapper drops that ramp.
            carry = lam + _ceil_div(max(wx - ipx - lam, 0), ipx) * ipx
            self._drop_override = ((carry - lam) // ipx) * p2
        r_t = torch.as_tensor(np.ascontiguousarray(r.T), dtype=self.dtype,
                              device=self.device)
        self._band = Band(r_t, ipx, wx, p2, carry,
                          banded.prepare_on_card(r_t, self._tier))

    def _init_state(self) -> torch.Tensor:
        return torch.zeros((self.batch, self._band.carry),
                           dtype=self.dtype, device=self.device)

    def _step(self, state, x):
        r_t, ipx, wx, p2, _, op = self._band
        return _fused_banded_step(r_t, state, x, ipx=ipx, wx=wx, p2=p2,
                                  op=op, dispatch=self.dispatch,
                                  tier=self._tier)

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- streaming API -----------------------------------------------------

    def reset(self):
        """Clear all streaming state (resampler.go:325-340)."""
        self.state = self._init_state()
        # Input accumulator: the RingBuffer role of the reference pipeline
        # (internal/pipeline/buffer.go:12-172).
        self._pending = SampleFIFO(self.batch, capacity=2 * self.block,
                                   dtype=self.np_dtype)
        self.samples_in = 0       # real input samples fed by the caller
        self.samples_out = 0      # canonical samples emitted to the caller
        self._core_emitted = 0    # core outputs seen (incl. transient prefix)
        self._flushed = False

    def set_carry(self, carry: np.ndarray) -> None:
        """Replace the step's carry (the last input samples it holds).

        ``carry`` is [batch, carry length], as the carry the engine would
        hold after some input.  Lets two engines start from one state.
        """
        carry = np.asarray(carry)
        want = (self.batch, self._band.carry)
        if carry.shape != want:
            raise ValueError(f"carry must be {want}, got {carry.shape}")
        self.state = self._to_device(carry)

    def _run_block(self, block_np: np.ndarray) -> np.ndarray:
        self.state, y, n = self._step(self.state, self._to_device(block_np))
        return y[:, :n].cpu().numpy()

    def _emit(self, core_out: np.ndarray, limit: int | None) -> np.ndarray:
        """Apply the transient-prefix drop and the canonical limit."""
        drop = self._drop_override
        start = 0
        if self._core_emitted < drop:
            start = min(drop - self._core_emitted, core_out.shape[1])
        self._core_emitted += core_out.shape[1]
        out = core_out[:, start:]
        if limit is not None:
            room = limit - self.samples_out
            out = out[:, :max(room, 0)]
        self.samples_out += out.shape[1]
        return out

    def process(self, x: np.ndarray) -> np.ndarray:
        """Resample a chunk; returns all output currently available.

        ``x`` is [batch, n] (or [n] for batch==1).  Per-call output counts
        differ from the reference (full micro-blocks are processed eagerly,
        the tail is held until more input or flush), but the concatenated
        stream is canonical.
        """
        if self._flushed:
            raise RuntimeError("process() after flush(); call reset() first")
        x = np.asarray(x, dtype=self.np_dtype)
        if x.ndim == 1:
            x = np.broadcast_to(x, (self.batch, x.shape[0])) if self.batch > 1 \
                else x[None, :]
        if x.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} streams, got {x.shape[0]}")
        self.samples_in += x.shape[1]
        self._pending.write(x)
        outs = []
        while self._pending.available() >= self.block:
            k = min(self.SCAN_BLOCKS, self._pending.available() // self.block)
            blk = self._pending.read(k * self.block)
            outs.append(self._emit(self._run_block(blk), None))
        if outs:
            return np.concatenate(outs, axis=1)
        return np.zeros((self.batch, 0), dtype=self.np_dtype)

    # -- device-resident streaming (serving / ML-ingest path) ---------------

    @property
    def device_chunk_multiple(self) -> int:
        """Input-chunk granularity for :meth:`process_device`: the fused
        operator's input period."""
        return self._band.ipx

    def _device_params(self) -> tuple[int, int]:
        """(input period, outputs per period) for the static-count step."""
        return self._band.ipx, self._band.p2

    def _emit_device(self, core_out: torch.Tensor, n_out: int,
                     limit: int | None) -> torch.Tensor:
        """Device-mode twin of :meth:`_emit` (keep the two in sync).

        All slice bounds are host-known (static counts), so nothing here
        synchronizes with the device.
        """
        drop = self._drop_override
        start = 0
        if self._core_emitted < drop:
            start = min(drop - self._core_emitted, n_out)
        self._core_emitted += n_out
        out = core_out[:, start:n_out]
        if limit is not None:
            room = limit - self.samples_out
            out = out[:, :max(room, 0)]
        self.samples_out += out.shape[1]
        return out

    def process_device(self, x) -> torch.Tensor:
        """Resample a chunk on the device; returns a tensor there.

        The serving-path alternative to :meth:`process`: the input is (or
        is copied to) a tensor on the engine's device, the whole chunk runs
        as one step, and the output stays on the device with no host
        synchronization: output counts are static, so every slice bound
        is known on the host.  The chunk width must be a multiple of
        :attr:`device_chunk_multiple`.  May be mixed with :meth:`process`
        whenever no host-side input is buffered there.
        """
        mult = self.device_chunk_multiple
        if self._flushed:
            raise RuntimeError("process() after flush(); call reset() first")
        if self._pending.available():
            raise RuntimeError(
                "process_device: host-buffered input pending from a prior "
                "process() call; feed block multiples there, or reset()")
        x = self._to_device(x)
        if x.dim() == 1:
            x = (x.expand(self.batch, x.shape[0]) if self.batch > 1
                 else x[None, :])
        if x.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} streams, got {x.shape[0]}")
        n = int(x.shape[1])
        if n % mult:
            raise ValueError(
                f"process_device chunk width {n} is not a multiple of "
                f"device_chunk_multiple={mult}")
        if n == 0:
            return torch.zeros((self.batch, 0), dtype=self.dtype,
                               device=self.device)
        self.samples_in += n
        self.state, y, _n = self._step(self.state, x)
        ipx, p2 = self._device_params()
        return self._emit_device(y, (n // ipx) * p2, None)

    def flush_device(self) -> torch.Tensor:
        """Drain all stage tails on the device; returns a tensor there.

        Device-mode counterpart of :meth:`flush`: static output counts keep
        the drain loop host-decidable, so the flush never synchronizes
        with the device either.
        """
        mult = self.device_chunk_multiple
        if self._flushed:
            return torch.zeros((self.batch, 0), dtype=self.dtype,
                               device=self.device)
        self._flushed = True
        lm = self.plan.lengths
        canonical_total = lm.canonical(self.samples_in)
        z = lm.flush_pad(self.samples_in) if self.samples_in > 0 else 0
        rem = self._pending.available()
        total_tail = rem + z
        ipx, p2 = self._device_params()
        outs = []
        if total_tail:
            n1 = _ceil_div(total_tail, mult) * mult
            tail = np.zeros((self.batch, n1), dtype=self.np_dtype)
            if rem:
                tail[:, :rem] = self._pending.read_all()
            self.state, y, _n = self._step(self.state, self._to_device(tail))
            outs.append(self._emit_device(y, (n1 // ipx) * p2,
                                          canonical_total))
        guard, limit = 0, self._flush_extra_limit()
        zeros_blk = None
        while self.samples_out < canonical_total:
            if zeros_blk is None:
                zeros_blk = torch.zeros((self.batch, self.block),
                                        dtype=self.dtype, device=self.device)
            self.state, y, _n = self._step(self.state, zeros_blk)
            outs.append(self._emit_device(y, (self.block // ipx) * p2,
                                          canonical_total))
            guard += 1
            if guard > limit:
                raise AssertionError(
                    "internal: flush under-produced "
                    f"({self.samples_out} < {canonical_total}) after "
                    f"{guard} extra blocks (limit {limit})")
        if outs:
            return torch.cat(outs, dim=1)
        return torch.zeros((self.batch, 0), dtype=self.dtype,
                           device=self.device)

    def stream(self, chunks, out: str = 'host'):
        """Pipelined streaming over an iterable of chunks (generator).

        The host-loop twin of :meth:`process_device` for callers that live
        in numpy: each input chunk is copied up and its step queued at
        once, but the copy back of chunk k waits until chunk k+1's step
        has been queued, so the transfer of one chunk overlaps the compute
        of the next.

        ``chunks`` yields arrays of any widths ([batch, n] or [n] for
        batch==1); a host-side remainder buffer carves them into
        :attr:`device_chunk_multiple` granules.  Yields the resampled
        stream in order, ending with the flush tail; the concatenation
        equals ``process(all) + flush()``.  ``out='host'`` yields
        ``np.ndarray``; ``out='device'`` yields tensors on the engine's
        device without downloading.
        """
        yield from pipelined_stream(self, chunks, out,
                                    self.device_chunk_multiple)

    def _flush_extra_limit(self) -> int:
        """Max extra zero blocks flush may legally need (exact holdback):
        the banded carry plus one window."""
        hold = self._band.carry + self._band.wx
        return _ceil_div(hold, self.block) + 2

    def flush(self) -> np.ndarray:
        """Drain all stage tails; returns the remaining canonical samples.

        Mirrors resampler.go:275-322 through the length model: the core is
        fed the exact zero padding that drains every stage, and the stream
        is trimmed to the canonical total.
        """
        if self._flushed:
            return np.zeros((self.batch, 0), dtype=self.np_dtype)
        self._flushed = True
        lm = self.plan.lengths
        canonical_total = lm.canonical(self.samples_in)
        z = lm.flush_pad(self.samples_in) if self.samples_in > 0 else 0
        rem = self._pending.available()
        # Feed remainder + z zeros, rounded up to whole blocks (extra zeros
        # only produce post-canonical samples, which the limit trims).
        total_tail = rem + z
        n_blocks = _ceil_div(total_tail, self.block) if total_tail else 0
        tail = np.zeros((self.batch, n_blocks * self.block),
                        dtype=self.np_dtype)
        if rem:
            tail[:, :rem] = self._pending.read_all()
        outs = []
        for i in range(n_blocks):
            blk = tail[:, i * self.block:(i + 1) * self.block]
            outs.append(self._emit(self._run_block(blk), canonical_total))
        # The fused step's block-granular emission may need a few extra
        # zero blocks to reach the canonical count.  The bound is exact
        # (the core holds back at most its carry plus one window), so
        # anything beyond it is a length-model bug: fail loudly.
        guard, limit = 0, self._flush_extra_limit()
        while self.samples_out < canonical_total:
            zeros_blk = np.zeros((self.batch, self.block), dtype=self.np_dtype)
            outs.append(self._emit(self._run_block(zeros_blk),
                                   canonical_total))
            guard += 1
            if guard > limit:
                raise AssertionError(
                    "internal: flush under-produced "
                    f"({self.samples_out} < {canonical_total}) after "
                    f"{guard} extra blocks (limit {limit})")
        if outs:
            return np.concatenate(outs, axis=1)
        return np.zeros((self.batch, 0), dtype=self.np_dtype)

    # -- introspection (resample.go:339-355, resampler.go:342-353) ---------

    def get_ratio(self) -> float:
        return self.plan.ratio

    def get_latency(self) -> int:
        return self.plan.latency()

    def estimate_output(self, n: int) -> int:
        return self.plan.estimate_output(n)

    def get_statistics(self) -> dict:
        return {"samplesIn": self.samples_in, "samplesOut": self.samples_out}
