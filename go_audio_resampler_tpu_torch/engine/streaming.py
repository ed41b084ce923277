"""Streaming engine: stateful Process/Flush over fixed-size blocks.

PyTorch counterpart of the JAX package's ``engine/streaming.py``.  The
topologies, each with its step:

- exact-rational two-stage plans (e.g. 44.1k <-> 48k; with the
  strict-antialias prefilter composed in), integer decimation (e.g.
  48k -> 16k, the ML-ingest path) and banded composites of a stage chain
  (``pipeline/fused.py``, e.g. 96k -> 44.1k): one periodic banded
  operator streamed through the fused banded step, i.e. the K1 kernel
  (``ops/fused.py``) on the card, with static output counts; a
  composite's first outputs follow its exact head rows instead;
- the general two-stage walk (non-exact ratios, e.g. 44.1k -> 48.001k):
  the strict-antialias prefilter where the plan has one (a 1:1 FIR, K1),
  the 2x polyphase prestage (K1, through ``ops/convolve.py``'s banded
  lowering), then the interpolated-coefficient polyphase emit
  (``stages.poly_emit``), whose output counts depend on the walk;
- cubic interpolation (every QUICK plan): the 32-bit walk and the 4-point
  Hermite kernel (``stages.cubic_process``), no matmul;
- integer upsampling (``dft_up``, e.g. 48k -> 96k): the prestage alone
  (K1), with static counts; a factor of 1 passes the input through.

As in the JAX package, a decimation filter of ``DECIM_FFT_MIN_TAPS`` taps
or more streams through FFT overlap-save (:func:`_fft_decim_step`; static
counts, one output per ``factor`` inputs), and a prefilter of
``FFT_CONV_MIN_TAPS`` taps or more through :func:`_fir_fft_step`, both on
``torch.fft`` (``engine/fftstage.py``) with the filter's spectrum computed
when the engine is built.

Each step is one plain function ``(state, block) -> (state', y, n)``; the
host wrapper feeds whole blocks from an input FIFO, so arbitrary chunk
sizes stream through it.  Each output sample is one fixed-order dot
product over the input, so the emitted stream depends only on the
concatenated input, not on how it was chunked.

Each engine runs its products at one matmul tier (``precision``,
resolved once when it is built; ``ops/precision.py``) and routes each
fused banded step through the dispatch gate (``dispatch``): the kernel,
or its plain version.  The prestage follows the gate at the tier, as the
JAX package's does, and takes K1's plain version inside
``precision.force_xla``.  ``dispatch='tune'`` measures both lowerings of
the engine's fused banded step on the card when the engine is built and
pins the faster (:meth:`EngineCore._tune_dispatch`): each lowering's
chain of steps is captured in CUDA graphs and timed by the slope between
two chain depths (:func:`_slope_measure`), and winners persist in a JSON
cache (``GAR_TUNE_CACHE_FILE``).

Flush follows the reference's orchestration (resampler.go:275-322) via
the length model: the engine feeds the zero padding that drains every
stage, then trims the total stream to the canonical output count.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build, banded, convolve, fused
from ..ops.precision import (DISPATCH_MODES, PRECISION_MODES, dispatch_for,
                             dot_precision)
from ..pipeline.buffer import SampleFIFO
from ..utils.spans import (ENGINE_D2H, ENGINE_EMIT, ENGINE_FIFO, ENGINE_H2D,
                           ENGINE_PROCESS, ENGINE_PROCESS_DEVICE,
                           ENGINE_STEP, span)
from . import fftstage, stages
from .oneshot import (DECIM_FFT_MIN_TAPS, FFT_CONV_MIN_TAPS, _decim_matrix,
                      _fused_rational_matrix, superframe)
from .plan import EnginePlan
from .stages import CubicState, PolyState, PrestageState

#: The int32 bound of the walks' limbs in the JAX package: a step's output
#: cap stays below 2^15, so that j * (a 16-bit limb) stays below 2^31.
CAP_LIMIT = 32767

#: Steps of ``EngineCore.process`` and ``flush`` whose block went up and
#: whose output came down through the engine's pinned host buffers (a
#: plain integer; callers may reset it to 0).
staged_steps = 0
#: Blocks that ``EngineCore.process`` staged straight from the caller's
#: array, past its input FIFO (a plain integer; callers may reset it to 0).
fifo_bypass_blocks = 0


def _check_knobs(dispatch: str, precision: str) -> str:
    """``dispatch`` and ``precision`` checked as the JAX engine checks
    them; returns the engine's tier (:func:`dot_precision` of
    ``precision``, 'auto' read from the process-wide tier now)."""
    if dispatch not in DISPATCH_MODES + ('tune',):
        raise ValueError(f"dispatch must be one of "
                         f"{DISPATCH_MODES + ('tune',)}, got {dispatch!r}")
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
                         tier: str, head=None) -> torch.Tensor:
    """Windows at j*ipx of width wx of ``head ++ data`` times r_t [wx, p2]
    -> [S, F*p2], at ``tier``.

    Where the gate lets ``dispatch`` through (``precision.dispatch_for``),
    the K1 kernel on a CUDA tensor (reading ``op``, and the head and the
    data where they lie) and its plain version on a CPU tensor; else the
    plain version on either.
    """
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=n_frames, tier=tier,
              head=head)
    if dispatch_for(dispatch, tier):
        return fused.fused_resample(data, r_t, op=op, **kw)
    return fused.fused_resample_reference(data, r_t, **kw)


def _next_carry(carry: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The last C samples of [carry ++ x], C = carry.shape[1], copied into
    rows laid out for K1 to read beside the next block in 16-byte copies:
    each row starts C samples before x's row does, modulo 4, and the rows
    lie x's row stride apart, modulo 4, as the next block's will where it
    has x's layout (a layout the kernel does not need, and reads 4 bytes
    at a time where it is not met)."""
    s, b = x.shape
    c = carry.shape[1]
    lead = (x.data_ptr() // x.element_size() - c) % 4
    ld = lead + c + (x.stride(0) - lead - c) % 4
    new = x.new_empty((s, ld))[:, lead:lead + c]
    if b >= c:
        new.copy_(x[:, b - c:])
    else:
        new[:, :c - b].copy_(carry[:, b:])
        new[:, c - b:].copy_(x)
    return new


def _fused_banded_step(r_t, carry, x, ipx, wx, p2, op=None,
                       dispatch='auto', *, tier):
    """The streaming step of the fused banded topologies (the JAX
    package's ``_step_rational_fused`` and ``_step_decim_fused``).

    Frames period-aligned windows of [carry ++ block] and applies the
    per-period matrix; with the block a multiple of the input period
    ``ipx``, every step emits exactly (B/ipx)*p2 samples.  K1 reads the
    carry and the block where they lie: the two are never joined.  The
    leading outputs of the stream are the zero-carry ramp, which the
    wrapper drops.  Returns ``(carry', y, n_valid)``; the new carry, the
    last C samples of [carry ++ block], is a copy (:func:`_next_carry`),
    so the step's input can be freed.
    """
    b = x.shape[1]
    n_frames = b // ipx
    carry = carry.to(x.dtype)
    if x.stride(1) != 1:
        x = x.contiguous()
    y = _banded_frames_apply(x, r_t, ipx, wx, p2, n_frames, op, dispatch,
                             tier=tier, head=carry)
    return _next_carry(carry, x), y, n_frames * p2


def _blockwise(block_step, block: int):
    """A walk's step over ``x`` of any width: ``block_step`` on each
    ``block`` samples in turn, the outputs concatenated."""
    def step(state, x):
        ys, n = [], 0
        for a in range(0, x.shape[1], block):
            state, y, k = block_step(state, x[:, a:a + block])
            ys.append(y[:, :k])
            n += k
        return state, (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]), n
    return step


def _fir_fft_step(spec: fftstage.Spectrum, carry: torch.Tensor,
                  x: torch.Tensor):
    """Causal streaming FIR via FFT overlap-save (long prototypes).

    The contract of ``stages.fir_process``: output i is
    sum_t h[t] * (carry ++ x)[i + t]; returns (carry', y).  ``spec`` is
    the filter's spectrum on the engine's device; used when the prefilter
    has ``FFT_CONV_MIN_TAPS`` taps or more.
    """
    xext = torch.cat([carry.to(x.dtype), x], dim=1)
    y = fftstage.fft_correlate(xext, spec, x.shape[1])
    return xext[:, x.shape[1]:].contiguous(), y


def _fft_decim_step(spec: fftstage.Spectrum, factor: int, carry, x):
    """Streaming decimation via FFT overlap-save (long prototypes).

    The carry discipline and canonical grid of the banded decimation step
    (window j reads (0^C ++ stream)[j*M : j*M+T], the zeros being the
    zero-initialized carry), with the correlation through
    ``fftstage.fft_correlate``.  Output counts stay static: B/M samples
    a block of B (a multiple of M).  Returns ``(carry', y, n_valid)``.
    """
    b = x.shape[1]
    n_frames = b // factor
    data = torch.cat([carry.to(x.dtype), x], dim=1)
    f = fftstage.fft_correlate(data, spec, (n_frames - 1) * factor + 1)
    return data[:, b:].contiguous(), f[:, ::factor][:, :n_frames], n_frames


def _host_copy(dst: np.ndarray, src) -> None:
    """``dst[...] = src`` on the host (``src`` a numpy array or a CPU
    tensor) by PyTorch's copy, which spreads a large copy over its threads
    where numpy's runs on one.  numpy copies the arrays PyTorch does not
    wrap: a negative stride (a reversed view), a stride of part of an
    element, and a read-only array (a broadcast mono input)."""
    if isinstance(src, np.ndarray) and not (
            src.flags.writeable
            and all(s >= 0 and s % src.itemsize == 0 for s in src.strides)):
        dst[...] = src
    else:
        torch.from_numpy(dst).copy_(torch.as_tensor(src))


def _host_streams(x, batch: int, dtype) -> np.ndarray:
    """A host chunk as [batch, n] streams of ``dtype``: [n] feeds every
    stream (a read-only broadcast where batch > 1)."""
    x = np.asarray(x, dtype=dtype)
    if x.ndim == 1:
        x = (np.broadcast_to(x, (batch, x.shape[0])) if batch > 1
             else x[None, :])
    if x.shape[0] != batch:
        raise ValueError(f"expected {batch} streams, got {x.shape[0]}")
    return x


def _slope_measure(fns: dict, depths: tuple, iters: int = 5,
                   timer=None) -> tuple:
    """Measure marginal (depth-slope) times per variant, with a jitter floor.

    ``fns[name](n)`` runs a synchronized chain of ``n`` steps; the score
    per variant is ``min_t(depths[1]) - min_t(depths[0])`` — the marginal
    cost of ``depths[1]-depths[0]`` steps, with the fixed per-call
    latency cancelled.  All (variant, depth) combinations are
    interleaved within each iteration so clock drift hits every cell
    equally; minima over iterations resist one-sided jitter.  ``timer``
    is injectable for tests.

    Returns ``(winner, contrast, jitter)``: ``contrast`` is the marginal
    gap between the best and second-best variant; ``jitter`` estimates
    the measurement noise floor of that gap — per timing cell, the gap
    between the two smallest samples bounds how settled the min is, and
    a marginal (the difference of two cell minima) inherits the sum of
    its cells' floors.  Callers compare contrast against jitter before
    trusting (or persisting) the winner.  (The JAX package's function,
    line for line.)
    """
    import time as _time

    timer = timer or _time.perf_counter
    n_lo, n_hi = depths
    times = {(m, n): [] for m in fns for n in (n_lo, n_hi)}
    for _ in range(iters):
        for m, fn in fns.items():
            for n in (n_lo, n_hi):
                t0 = timer()
                fn(n)
                times[(m, n)].append(timer() - t0)
    marginal = {m: min(times[(m, n_hi)]) - min(times[(m, n_lo)])
                for m in fns}

    def cell_floor(samples):
        if len(samples) < 2:
            return 0.0
        s = sorted(samples)
        return s[1] - s[0]

    jitter = max(cell_floor(times[(m, n_hi)]) + cell_floor(times[(m, n_lo)])
                 for m in fns)
    ranked = sorted(fns, key=marginal.get)
    winner = ranked[0]
    contrast = (marginal[ranked[1]] - marginal[ranked[0]]
                if len(ranked) > 1 else float('inf'))
    return winner, contrast, jitter


def _slope_pick(fns: dict, depths: tuple, iters: int = 5,
                timer=None) -> str:
    """The variant with the smallest marginal time (see _slope_measure)."""
    return _slope_measure(fns, depths, iters, timer)[0]


def _tune_cache_path():
    """Tune-cache file, or None when disabled (GAR_TUNE_CACHE_FILE=).

    The JAX package reads the same variable; the default lies apart
    from its file."""
    path = os.environ.get(
        "GAR_TUNE_CACHE_FILE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "go_audio_resampler_tpu_torch", "tune.json"))
    return path or None


def _tune_cache_read(path: str) -> dict:
    """The cache file's entries; an absent, unreadable or corrupt file
    has none."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _tune_cache_get(key: str):
    path = _tune_cache_path()
    if path is None:
        return None
    return _tune_cache_read(path).get(key)


def _tune_cache_put(key: str, entry) -> None:
    """Persist a tune entry: a bare winner string (legacy) or a dict
    ``{"winner": ..., "contrast_s": ..., "jitter_s": ...}`` recording the
    measured margin so a later reader can judge how settled the pin is.

    The file is replaced atomically (a temporary file, then
    ``os.replace``).  A cache that cannot be written is skipped: the
    engine keeps its pin."""
    path = _tune_cache_path()
    if path is None:
        return
    data = _tune_cache_read(path)
    data[key] = entry
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)          # atomic on POSIX
    except OSError:
        pass


def _tune_measures(device: torch.device) -> bool:
    """Does ``dispatch='tune'`` measure on ``device``?  Only on the card:
    elsewhere both lowerings are the same plain version, and the tune
    gives 'auto' (as the JAX package's does off the TPU)."""
    return device.type == 'cuda'


@functools.lru_cache(maxsize=None)
def _card_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit`` prints them, or 'cpu'; read once a process.  A
    card that ``nvidia-smi`` does not list is named by PyTorch, its power
    limit unknown."""
    if device.type != 'cuda':
        return 'cpu'
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    uuid = str(getattr(torch.cuda.get_device_properties(index), 'uuid', ''))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        out = ''
    lines = out.strip().splitlines()
    for line in lines:
        card_uuid, _, label = line.partition(', ')
        if len(lines) == 1 or (
                uuid and card_uuid.strip().removeprefix('GPU-') == uuid):
            return label.strip()
    return f"{torch.cuda.get_device_name(index)}, power limit unknown"


def _kernel_digest() -> str:
    """The library names of K1 and K2, which carry the digests of their
    sources (``ops/_build.py``): a pin never outlives the kernels it
    measured."""
    return ' '.join(_build.library_path(name).name
                    for name in ('fused_resample', 'fused_resample_tmajor'))


def _run_chain(core, state, x, depth: int) -> None:
    for _ in range(depth):
        state, _y, _n = core(state, x)


class _Chain:
    """Chained steps of one lowering for ``dispatch='tune'``: calling it
    with a depth runs that many steps of ``core`` from ``init_state()``
    on the zero block ``x``, waits for them, and keeps the seconds they
    took.

    On the card each depth is one CUDA graph, so that a chain's time is
    device time and not the host's enqueue: one eager step first, on a
    side stream, then each graph captured and replayed once before it is
    timed.  Elsewhere (a forced tune on the CPU) the chain runs eagerly.
    """

    def __init__(self, core, init_state, x: torch.Tensor, depths):
        self.seconds = {n: [] for n in depths}
        self.graphs = {}
        self.device = x.device
        state = init_state()
        if x.device.type == 'cuda':
            side = torch.cuda.Stream(x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(side):
                core(state, x)
            torch.cuda.current_stream(x.device).wait_stream(side)
            for n in depths:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    _run_chain(core, state, x, n)
                self.graphs[n] = graph
            self._run = lambda n: self.graphs[n].replay()
        else:
            self._run = functools.partial(_run_chain, core, state, x)
        for n in depths:                 # once before timing
            self(n)
            self.seconds[n].clear()

    def __call__(self, n: int) -> None:
        t0 = time.perf_counter()
        self._run(n)
        if self.graphs:
            torch.cuda.synchronize(self.device)
        self.seconds[n].append(time.perf_counter() - t0)

    def marginal_ms(self) -> float | None:
        """ms a step: the slope between the two depths' fastest timed
        runs (None before any)."""
        (lo, t_lo), (hi, t_hi) = sorted(self.seconds.items())
        if not (t_lo and t_hi):
            return None
        return (min(t_hi) - min(t_lo)) / (hi - lo) * 1e3


class _CanonicalStream:
    """The canonical-stream bookkeeping of the streaming engines
    (``EngineCore``'s host and device paths, ``TimeMajorEngine``): the
    counters, the emit and the flush's drain.  An engine sets ``plan``,
    ``block``, ``_drop`` (the leading core outputs the wrapper drops) and
    ``_flush_limit`` (the extra zero blocks a flush may need) when it is
    built, and ``EngineCore`` a banded composite's head rows."""

    _head_t = None

    def reset(self):
        self.samples_in = 0       # real input samples fed by the caller
        self.samples_out = 0      # canonical samples emitted to the caller
        self._core_emitted = 0    # core outputs seen (incl. transient prefix)
        self._flushed = False

    def estimate_output(self, n: int) -> int:
        return self.plan.estimate_output(n)

    def _head_rows(self, n: int) -> torch.Tensor | None:
        """Of the next ``n`` canonical outputs, those in a composite's
        head: its exact rows over 0^lam ++ the input's prefix, [S, k] in
        float64 (on the card whatever ``allow_tf32`` says) on the engine's
        device; None where no output falls in a head.

        Every call forms the product of all the head rows, one shape, so
        the host and device routes give the same bits.  An output's row
        reads only inputs consumed before its emit, and a sample not yet
        collected is 0 against a 0 coefficient."""
        k0 = self.samples_out
        if self._head_t is None or not n or k0 >= self._head_t.shape[1]:
            return None
        k1 = min(self._head_t.shape[1], k0 + n)
        return (self._head_xe @ self._head_t)[:, k0:k1]

    def _emit(self, y, n_out: int, limit: int | None, axis: int = 1):
        """The canonical part of a step's ``n_out`` core outputs ``y`` (a
        numpy array or a tensor, time on ``axis``), a view: the ramp drop,
        then at most ``limit`` canonical outputs in all, a composite's head
        rows written in (stream-major only).  Only a host array's head rows
        wait for the device."""
        with span(ENGINE_EMIT):
            a = min(max(self._drop - self._core_emitted, 0), n_out)
            b = n_out if limit is None else min(
                n_out, a + max(limit - self.samples_out, 0))
            self._core_emitted += n_out
            out = y[:, a:b] if axis else y[a:b]
            head = self._head_rows(b - a)
            if head is not None:
                # Only a banded composite has head rows, and its step's
                # output is always new (only dft_up of factor 1 passes its
                # input through), so this never writes the caller's data.
                out[:, :head.shape[1]] = (head.cpu().numpy() if isinstance(
                    out, np.ndarray) else head)
            self.samples_out += b - a
            return out

    def _drain(self, tail, extra, axis: int = 1) -> list:
        """The flush: feed the zero padding that drains every stage
        (``lengths.flush_pad``) and emit up to the canonical total; the
        emitted pieces in order, none after the first flush.

        ``tail(z)`` runs the steps over the input still held and ``z``
        zeros, in the caller's widths, yielding each ``(y, n_out)``;
        ``extra()`` runs one step over a zero block.
        """
        if self._flushed:
            return []
        self._flushed = True
        lm = self.plan.lengths
        total = lm.canonical(self.samples_in)
        z = lm.flush_pad(self.samples_in) if self.samples_in > 0 else 0
        outs = [self._emit(y, n, total, axis) for y, n in tail(z)]
        # Block-granular steps may need a few extra zero blocks to reach
        # the canonical count.  The bound is exact (the core holds back at
        # most its history), so anything beyond it is a length-model bug:
        # fail loudly.
        guard = 0
        while self.samples_out < total:
            outs.append(self._emit(*extra(), total, axis))
            guard += 1
            if guard > self._flush_limit:
                raise AssertionError(
                    "internal: flush under-produced "
                    f"({self.samples_out} < {total}) after {guard} extra "
                    f"blocks (limit {self._flush_limit})")
        return outs


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

    def _pop(pend):
        return pend.cpu().numpy() if out == 'host' else pend

    pend = None                              # queued, not downloaded
    buf = np.zeros((eng.batch, 0), eng.np_dtype)
    for x in chunks:
        buf = np.concatenate([buf, _host_streams(x, eng.batch, eng.np_dtype)],
                             axis=1)
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


class EngineCore(_CanonicalStream):
    """Stateful streaming resampler over a batch of independent streams.

    The reference processes channels with one goroutine each
    (constant.go:224-241); here all ``batch`` streams ride the leading
    tensor axis through one step per block.

    Topologies: exact-rational two-stage plans, integer decimation and
    banded composites (``pipeline.fused.BandedPlan``; the fused banded
    step, K1), the general two-stage walk of non-exact ratios (K1
    prestage, then the polyphase emit; a strict-antialias prefilter
    first, K1), cubic (QUICK plans; no kernel) and integer upsampling
    (``dft_up``; K1).  Prefilters of ``FFT_CONV_MIN_TAPS`` taps or more
    and decimation filters of ``DECIM_FFT_MIN_TAPS`` taps or more run
    through FFT overlap-save (``torch.fft``).

    Parameters:
      plan:   built engine plan (filters + topology), or a
              ``pipeline.fused.BandedPlan``
      batch:  number of parallel streams S
      block:  internal micro-block size B (input samples per step): for
              the fused banded steps rounded up to a multiple of the
              operator's input period; for the walks halved until a step's
              output cap fits the walks' 15-bit bound
      dtype:  compute dtype: float32 (the only type the CUDA kernel takes)
              or float64 (CPU parity runs)
      dispatch: 'auto' or 'pallas' (the K1 kernel on CUDA, its plain
              version on the CPU), or 'xla' (the plain version on either)
              for the fused banded steps; 'tune' measures the kernel and
              the plain version on the card when the engine is built and
              pins the faster (:meth:`_tune_dispatch`), so that
              ``dispatch`` reads 'pallas', 'xla' or 'auto' afterwards
      precision: the matmul tier of float32 steps: 'highest' (float32-
              accurate), 'high' (three bf16 passes), 'default' (one bf16
              pass), or 'auto' (GAR_TPU_MATMUL_PRECISION, read when the
              engine is built; ``ops/precision.py``).  float64 is exact at
              every tier.
      device: where the engine's tensors live; 'cuda' by default.  Without
              a GPU the default raises; pass device='cpu' to run the plain
              version on the CPU.
    """

    #: blocks per step when process() has many buffered blocks: the static-
    #: count topologies run them as one step (bit-identical to block-by-
    #: block steps), the walks block by block within one call
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
        # The host ends of process()'s and flush()'s copies, flat and
        # allocated on their first step (_host_buffer); pinned on the card.
        self._pinned = self.device.type == 'cuda'
        self._stage_in = self._stage_out = None
        self._flush_limit = _ceil_div(self._build_constants(), self.block) + 2
        #: What ``dispatch='tune'`` found (:meth:`_tune_dispatch`); None
        #: for any other dispatch.
        self.tune_record = None
        if dispatch == 'tune':
            self.dispatch = self._tune_dispatch()
        self.reset()

    #: chain depths for dispatch='tune' (see _tune_dispatch): the winner
    #: is the smaller MARGINAL time between these two depths.
    TUNE_DEPTHS = (4, 36)
    #: A tune winner is pinned/persisted only when the marginal-time
    #: contrast exceeds this multiple of the session's jitter floor.
    TUNE_NOISE_FACTOR = 2.0

    def _tune_dispatch(self, persist: bool = True) -> str:
        """Pick the faster lowering of the fused banded step by measuring
        device time, at this engine's (batch, block, dtype, tier).

        Each lowering ('pallas', the K1 kernel; 'xla', its plain version)
        runs chains of :meth:`core_fn` steps from :meth:`_init_state` on
        a zero block, one CUDA graph per (lowering, depth)
        (:class:`_Chain`), and the score is the slope between the two
        depths of ``TUNE_DEPTHS``: marginal seconds a step, with the
        fixed cost of a replay and its synchronize cancelled.  A step's
        host enqueue (tens of µs against a few of kernel) is not
        measured.  The graphs are freed when the tune returns.

        Gives 'auto' without measuring off the card and where the engine
        has no banded step (the walk, cubic, dft_up, FFT decimation).
        Winners persist per :meth:`_tune_key` in a JSON cache
        (``GAR_TUNE_CACHE_FILE``, default
        ``~/.cache/go_audio_resampler_tpu_torch/tune.json``; empty
        disables it); a hit pins without capturing anything.  Where the
        contrast is below ``TUNE_NOISE_FACTOR`` times the jitter the pin
        is 'auto' and nothing is written.  ``persist=False`` writes
        nothing either (a sharded engine's ranks other than 0).

        An error of either lowering (a build, a launch, a capture)
        propagates: the tune never turns a failure into a pin.  Records
        what it found in ``tune_record``.
        """
        t0 = time.perf_counter()
        rec = self.tune_record = {'pin': 'auto', 'source': 'off the card',
                                  'graphs': 0}
        if self._band is None:
            rec['source'] = 'no banded step'
        if self._band is None or not _tune_measures(self.device):
            return 'auto'
        key = self._tune_key()
        cached = _tune_cache_get(key)
        if isinstance(cached, dict):
            cached = cached.get('winner')
        if cached in ('pallas', 'xla'):
            rec.update(pin=cached, source='cache',
                       seconds=time.perf_counter() - t0)
            return cached
        x = torch.zeros((self.batch, self.block), dtype=self.dtype,
                        device=self.device)
        saved, fns = self.dispatch, {}
        try:
            for mode in ('pallas', 'xla'):
                self.dispatch = mode
                fns[mode] = _Chain(self.core_fn(), self._init_state, x,
                                   self.TUNE_DEPTHS)
        finally:
            self.dispatch = saved
        winner, contrast, jitter = _slope_measure(fns, self.TUNE_DEPTHS)
        rec.update(source='measured', contrast_s=contrast, jitter_s=jitter,
                   marginal_ms={m: fn.marginal_ms() for m, fn in fns.items()},
                   graphs=sum(len(fn.graphs) for fn in fns.values()))
        del fns
        if contrast < self.TUNE_NOISE_FACTOR * jitter:
            # The marginal gap is indistinguishable from timing noise: do
            # not pin, do not persist.
            rec['seconds'] = time.perf_counter() - t0
            return 'auto'
        if persist:
            _tune_cache_put(key, {'winner': winner, 'contrast_s': contrast,
                                  'jitter_s': jitter})
        rec.update(pin=winner, seconds=time.perf_counter() - t0)
        return winner

    def _tune_key(self) -> str:
        """Stable tune-cache key: the plan's identity, the engine's
        shape, dtype and resolved tier, the card (name and power limit),
        and the package, PyTorch and CUDA versions with the digest of
        the K1 and K2 sources, so a pin never outlives the kernels it
        measured."""
        from .. import __version__
        return repr((self.plan.fingerprint, self.batch, self.block,
                     str(self.dtype), self._tier, _card_label(self.device),
                     __version__, torch.__version__, torch.version.cuda,
                     _kernel_digest()))

    # -- construction ------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _build_constants(self) -> int:
        """The topology's constants, and the facts the paths read: the
        static period (input period, outputs per period; None where output
        counts depend on the data) and the ramp drop (_CanonicalStream).
        Returns the input the core can hold back without emitting, which
        bounds a flush's extra zero blocks: its history (the banded carry
        and one window, the walk's hist_size and the prefilter's group
        delay, the prestage carry, cubic's 3-sample window)."""
        p = self.plan
        self._band = None
        self._decim_fft = None
        self._period = None
        self._drop = p.lengths.drop_prefix()
        # Exact-rational plans fold the strict-antialias prefilter into the
        # fused banded operator (oneshot._fused_rational_matrix); the host
        # FIFO of the prefilter runs only ahead of the non-exact walk.
        self._has_aa = (p.kind == 'two_stage' and p.aa_taps > 0
                        and not p.is_rational_exact)
        if p.kind == 'two_stage' and not p.is_rational_exact:
            self._build_walk()
            return self.hist_size + (2 * self._aa_delay if self._has_aa
                                     else 0)
        if p.kind == 'cubic':
            self._build_cubic()
            return 4
        if p.kind == 'dft_up':
            self._pre_bands = {}
            if p.factor > 1:
                self.pre_coeffs = self._tensor(p.pre_coeffs)
                self._pre_band(self.block)
            self._period = (1, p.factor)
            return max(p.pre_taps - 1, 0)
        if p.kind == 'decimate' and p.decim_taps >= DECIM_FFT_MIN_TAPS:
            # Long prototype: stream through _fft_decim_step, one output
            # per factor inputs, the block a multiple of the factor; the
            # carry and its ramp as the banded step's (below).
            self._decim_fft = fftstage.spectrum(p.decim_coeffs, self.dtype,
                                                self.device)
            self.block = _ceil_div(self.block, p.factor) * p.factor
            self._decim_carry = (_ceil_div(p.decim_taps - 1, p.factor)
                                 * p.factor)
            self._period = (p.factor, 1)
            self._drop = self._decim_carry // p.factor
            return self._decim_carry + p.decim_taps
        if p.kind == 'decimate':
            r, _, ipx = _decim_matrix(p)
        elif p.kind == 'two_stage':
            # Fused streaming: the whole cascade (and the strict-antialias
            # prefilter, where present) as one periodic banded matmul
            # (oneshot._fused_rational_matrix).
            r, _, ipx, lam = _fused_rational_matrix(p)
        elif p.kind == 'banded':
            # A composite of a stage chain (pipeline/fused.py): canonical
            # period m reads (0^lam ++ x)[m*I : m*I + W].  Where the
            # composite has an aperiodic head, its first n_head canonical
            # outputs are the exact head rows over the input's prefix
            # (_CanonicalStream._emit).
            op = p.op
            r, ipx, lam = op.R, op.I, op.lam
            if op.head is not None:
                self._head_t = torch.as_tensor(
                    np.ascontiguousarray(op.head.T), dtype=torch.float64,
                    device=self.device)
        else:
            raise ValueError(f"EngineCore: unknown topology {p.kind!r}")
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
            self._drop = carry // p.factor
        else:
            # The zero carry C >= Wx-Ipx with C == lam (mod Ipx) places the
            # canonical grid (C-lam)/Ipx periods into the core stream; the
            # wrapper drops that ramp.
            carry = lam + _ceil_div(max(wx - ipx - lam, 0), ipx) * ipx
            self._drop = ((carry - lam) // ipx) * p2
        r_t = torch.as_tensor(np.ascontiguousarray(r.T), dtype=self.dtype,
                              device=self.device)
        self._band = Band(r_t, ipx, wx, p2, carry,
                          banded.prepare_on_card(r_t, self._tier))
        self._period = (ipx, p2)
        return carry + wx

    def _build_walk(self):
        """The general two-stage walk's constants (the JAX engine's
        ``poly_cap``, ``poly_keep`` and ``hist_size``)."""
        p = self.plan
        self.pre_coeffs = self._tensor(p.pre_coeffs)
        self.banks = tuple(self._tensor(b) for b in
                           (p.bank_a, p.bank_b, p.bank_c, p.bank_d))

        def cap(block):
            return _ceil_div(block * p.factor * p.num_phases * 65536,
                             p.step) + 1

        # The walk's limbs stay within the JAX package's int32 bounds: a
        # step emits at most CAP_LIMIT outputs.
        while cap(self.block) > CAP_LIMIT:
            if self.block <= 1:
                raise ValueError(
                    f"EngineCore: the walk's step {p.step} emits "
                    f"{cap(self.block)} > {CAP_LIMIT} outputs from a single "
                    "input sample; no block fits the walk's bound")
            self.block //= 2
        m = self.block * p.factor
        self.poly_cap = cap(self.block)
        # keep = residual history bound (the JAX package's poly_process)
        step_in = _ceil_div(p.step, p.num_phases * 65536)
        self.poly_keep = p.poly_taps + step_in + 2
        self.hist_size = self.poly_keep + m + p.lengths.core_delta()
        self._pre_bands = {}
        self._pre_band(self.block)
        if self._has_aa:
            # The prefilter's FIR runs one block at a time (_aa_push):
            # at FFT_CONV_MIN_TAPS taps or more by overlap-save on its
            # spectrum, else one K1 operator for T-1+block samples, each
            # prepared here.
            self._aa_coeffs = self._tensor(p.aa_coeffs)
            self._aa_delay = (p.aa_taps - 1) // 2
            self._aa_spec = (fftstage.spectrum(p.aa_coeffs, self.dtype,
                                               self.device)
                             if p.aa_taps >= FFT_CONV_MIN_TAPS else None)
            self._aa_band = (convolve.band_operator(
                self._aa_coeffs[None, :], p.aa_taps - 1 + self.block, 1,
                self.dtype, self.device, self._tier)
                if self.device.type == 'cuda' and self._aa_spec is None
                else None)

    def _build_cubic(self):
        p = self.plan
        self.cubic_cap = _ceil_div(self.block << 32, p.cubic_step) + 1
        # The same bound as the walk's; a block of 1 keeps its cap.
        while self.cubic_cap > CAP_LIMIT and self.block > 1:
            self.block //= 2
            self.cubic_cap = _ceil_div(self.block << 32, p.cubic_step) + 1

    def _pre_band(self, width: int) -> convolve.ConvBand | None:
        """The prestage's K1 operator for steps of ``width`` input
        samples: one per band period (``min(128, width)``), built and
        prepared at the engine's tier on first use; None on the CPU, whose
        lowering reads the coefficients."""
        if self.device.type != 'cuda':
            return None
        t1 = self.plan.pre_taps
        period = convolve._band_period(t1 - 1 + width, t1, 1)
        band = self._pre_bands.get(period)
        if band is None:
            band = convolve.band_operator(self.pre_coeffs, t1 - 1 + width, 1,
                                          self.dtype, self.device,
                                          self._tier)
            self._pre_bands[period] = band
        return band

    def _init_state(self):
        p, s, d, dev = self.plan, self.batch, self.dtype, self.device
        if self._band is not None:
            return torch.zeros((s, self._band.carry), dtype=d, device=dev)
        if self._decim_fft is not None:
            return torch.zeros((s, self._decim_carry), dtype=d, device=dev)
        if p.kind == 'cubic':
            return CubicState(carry=torch.zeros((s, 3), dtype=d, device=dev),
                              at_int=0, at_f1=0, at_f0=0)
        pre = PrestageState(carry=torch.zeros(
            (s, max(p.pre_taps - 1, 0)), dtype=d, device=dev))
        if p.kind == 'dft_up':
            return pre
        return (pre, PolyState(
            hist=torch.zeros((s, self.hist_size), dtype=d, device=dev),
            hist_len=0, at_hi=p.at0 >> 16, at_lo=p.at0 & 0xFFFF))

    def core_fn(self):
        """The pure step of this engine's topology, ``(state, x) ->
        (state', y, n)`` over the state of :meth:`_init_state`:
        ``y[:, :n]`` are the core's outputs.  The walks (the general
        walk, cubic) step block by block over ``x`` and return only
        their ``n`` outputs.

        The lowering (``dispatch``) and the tier are those of the moment
        it is called: a later change of ``dispatch`` does not reach a
        function already returned.  The tune's chains call it.
        """
        p = self.plan
        if self._band is not None:
            r_t, ipx, wx, p2, _, op = self._band
            return functools.partial(_fused_banded_step, r_t, ipx=ipx,
                                     wx=wx, p2=p2, op=op,
                                     dispatch=self.dispatch,
                                     tier=self._tier)
        if self._decim_fft is not None:
            return functools.partial(_fft_decim_step, self._decim_fft,
                                     p.factor)
        if p.kind == 'dft_up' and p.factor == 1:
            # unity ratio: pass-through (dft_stage.go:57-59)
            return lambda state, x: (state, x, x.shape[1])
        tier = self._tier
        if p.kind == 'cubic':
            def cubic_block(state, x):
                state, y, _, n = stages.cubic_process(
                    state, x, p.cubic_step, self.cubic_cap)
                return state, y, n
            return _blockwise(cubic_block, self.block)

        def prestage(state, x):
            return stages.prestage_process(self.pre_coeffs, state, x,
                                           p.factor, tier,
                                           band=self._pre_band(x.shape[1]))

        if p.kind == 'dft_up':
            def dft_up(state, x):
                state, u = prestage(state, x)
                return state, u, u.shape[1]
            return dft_up

        def walk_block(state, x):
            # The general walk: the prestage (K1 on the card), then the
            # polyphase emit.
            pre, poly = state
            pre, u = prestage(pre, x)
            poly, y, _, n = stages.poly_process(
                self.banks, poly, u, p.num_phases, p.poly_taps, p.step_hi,
                p.step_lo, self.poly_cap, tier)
            return (pre, poly), y, n
        return _blockwise(walk_block, self.block)

    def _step(self, state, x):
        """One step of :meth:`core_fn` at the engine's current
        ``dispatch``."""
        with span(ENGINE_STEP):
            return self.core_fn()(state, x)

    def _to_device(self, x) -> torch.Tensor:
        with span(ENGINE_H2D):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- streaming API -----------------------------------------------------

    def reset(self):
        """Clear all streaming state (resampler.go:325-340)."""
        super().reset()
        self.state = self._init_state()
        # Input accumulator: the RingBuffer role of the reference pipeline
        # (internal/pipeline/buffer.go:12-172).
        self._pending = SampleFIFO(self.batch, capacity=2 * self.block,
                                   dtype=self.np_dtype)
        if self._head_t is not None:
            # The head rows' input, 0^lam ++ (the input's first samples),
            # in float64 on the engine's device (see _head_rows).
            self._head_xe = torch.zeros((self.batch, self._head_t.shape[0]),
                                        dtype=torch.float64,
                                        device=self.device)
            self._head_have = 0
        if self._has_aa:
            self._aa_carry = torch.zeros((self.batch, self.plan.aa_taps - 1),
                                         dtype=self.dtype, device=self.device)
            self._aa_raw = SampleFIFO(self.batch, capacity=2 * self.block,
                                      dtype=self.np_dtype)
            self._aa_causal = 0      # causal FIR outputs produced so far
            self._aa_delivered = 0   # centered samples handed downstream

    # -- strict-antialias prefilter (EnginePlan.aa_coeffs) ------------------

    def _aa_push(self, x: np.ndarray) -> np.ndarray:
        """Stream raw samples through the prefilter, one block a step (K1
        on the card, reading the engine's operator); return the centered
        (delay-compensated) filtered samples now available."""
        with span(ENGINE_FIFO):
            self._aa_raw.write(x)
        outs = []
        while self._aa_raw.available() >= self.block:
            with span(ENGINE_FIFO):
                blk = self._aa_raw.read(self.block)
            blk = self._to_device(blk)
            if self._aa_spec is not None:
                self._aa_carry, y = _fir_fft_step(self._aa_spec,
                                                  self._aa_carry, blk)
            else:
                self._aa_carry, y = stages.fir_process(
                    self._aa_coeffs, self._aa_carry, blk, self._tier,
                    band=self._aa_band)
            with span(ENGINE_D2H):
                outs.append(y.cpu().numpy())
        if not outs:
            return np.zeros((self.batch, 0), dtype=self.np_dtype)
        y = np.concatenate(outs, axis=1)
        skip = min(max(self._aa_delay - self._aa_causal, 0), y.shape[1])
        self._aa_causal += y.shape[1]
        y = y[:, skip:]
        self._aa_delivered += y.shape[1]
        return y

    def _aa_drain(self, extra: int) -> np.ndarray:
        """Flush the prefilter: the centered stream totals samples_in +
        extra.

        ``extra`` is the core's flush padding; filtering it through the
        prefilter (instead of appending raw zeros after a hard truncation
        at samples_in) lets the prefilter's tail extend into it, the same
        semantics as the composed fused matrix and the one-shot path."""
        target = self.samples_in + extra
        remaining = target - self._aa_delivered
        if remaining <= 0:
            return np.zeros((self.batch, 0), dtype=self.np_dtype)
        total = self._aa_raw.available() + extra + self._aa_delay
        zpad = (_ceil_div(total, self.block) * self.block
                - self._aa_raw.available())
        out = self._aa_push(np.zeros((self.batch, zpad),
                                     dtype=self.np_dtype))
        out = out[:, :remaining]
        self._aa_delivered = target
        return out

    # -- the banded composite's head rows ------------------------------------

    def _collect_head(self, x) -> None:
        """Keep the input's first samples (a numpy array or a tensor) that
        the head rows read, in float64 on the engine's device."""
        lam = self.plan.op.lam
        take = min(self._head_xe.shape[1] - lam - self._head_have,
                   x.shape[1])
        if take > 0:
            a = lam + self._head_have
            self._head_xe[:, a:a + take] = torch.as_tensor(
                np.array(x[:, :take]) if isinstance(
                    x, np.ndarray) else x[:, :take]).to(self._head_xe)
            self._head_have += take

    def set_carry(self, carry: np.ndarray) -> None:
        """Replace the step's carry (the last input samples it holds).

        ``carry`` is [batch, carry length], as the carry the engine would
        hold after some input.  Lets two engines start from one state.
        Only the fused banded steps' state is one carry.
        """
        if self._band is None:
            raise NotImplementedError(
                f"set_carry: the {self.plan.kind!r} topology's state is not "
                "one carry")
        carry = np.asarray(carry)
        want = (self.batch, self._band.carry)
        if carry.shape != want:
            raise ValueError(f"carry must be {want}, got {carry.shape}")
        self.state = self._to_device(carry)

    def _host_buffer(self, attr: str, shape) -> tuple[torch.Tensor,
                                                      np.ndarray]:
        """The engine's staging buffer ``attr`` ('_stage_in' or
        '_stage_out'): its first elements viewed as ``shape``, as a tensor
        (pinned on the card) and as the numpy array over the same memory.
        Allocated on first use, grown only for a larger step."""
        n = shape[0] * shape[1]
        buf = getattr(self, attr)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=self.dtype, pin_memory=self._pinned)
            setattr(self, attr, buf)
        t = buf[:n].view(shape)
        return t, t.numpy()

    def _stage_tail(self) -> torch.Tensor:
        """A block of the flush staged: what the FIFO still holds, then
        zeros."""
        staged, buf = self._host_buffer('_stage_in', (self.batch, self.block))
        n = self._pending.read_into(buf)
        buf[:, n:] = 0
        return staged

    def _run_block(self, staged: torch.Tensor) -> tuple[np.ndarray, int]:
        """One step over the block in the input staging buffer; returns its
        core outputs as a new array, written once (on the card from the
        pinned output buffer, on the CPU from the step's output), and
        their count.  On the card the H2D is asynchronous; the blocking D2H
        behind it on the same stream is done before this returns, and with
        it every copy that read the staging buffers, so the host may write
        them again."""
        global staged_steps
        with span(ENGINE_H2D):
            x = torch.empty(staged.shape, dtype=self.dtype,
                            device=self.device)
            x.copy_(staged, non_blocking=self._pinned)
        self.state, y, n = self._step(self.state, x)
        with span(ENGINE_D2H):
            y = y[:, :n]
            if self._pinned:
                y_host, _ = self._host_buffer('_stage_out', tuple(y.shape))
                y_host.copy_(y)
                staged_steps += 1
                y = y_host
            out = np.empty(tuple(y.shape), dtype=self.np_dtype)
            _host_copy(out, y)
            return out, n

    def process(self, x: np.ndarray) -> np.ndarray:
        """Resample a chunk; returns all output currently available.

        ``x`` is [batch, n] (or [n] for batch==1).  Per-call output counts
        differ from the reference (full micro-blocks are processed eagerly,
        the tail is held until more input or flush), but the concatenated
        stream is canonical.

        Whole blocks of a call that finds the input FIFO empty go from
        ``x`` straight into the engine's input staging buffer; the rest
        waits in the FIFO.  The returned array is new and the caller's.
        """
        global fifo_bypass_blocks
        with span(ENGINE_PROCESS):
            if self._flushed:
                raise RuntimeError(
                    "process() after flush(); call reset() first")
            x = _host_streams(x, self.batch, self.np_dtype)
            self.samples_in += x.shape[1]
            if self._head_t is not None:
                self._collect_head(x)
            if self._has_aa:
                x = self._aa_push(x)
            with span(ENGINE_FIFO):
                direct = (0 if self._pending.available()
                          else x.shape[1] // self.block * self.block)
                self._pending.write(x[:, direct:])
            outs, at = [], 0
            # The FIFO holds less than a block while x's whole blocks go.
            while (k := min(self.SCAN_BLOCKS,
                            (direct - at + self._pending.available())
                            // self.block)):
                with span(ENGINE_FIFO):
                    staged, buf = self._host_buffer(
                        '_stage_in', (self.batch, k * self.block))
                    if at < direct:
                        _host_copy(buf, x[:, at:at + k * self.block])
                        at += k * self.block
                        fifo_bypass_blocks += k
                    else:
                        self._pending.read_into(buf)
                outs.append(self._emit(*self._run_block(staged), None))
            with span(ENGINE_EMIT):
                return self._host_join(outs)

    def _host_join(self, outs: list) -> np.ndarray:
        """The host pieces of one call as one array: the one piece itself,
        else their concatenation."""
        if len(outs) == 1:
            return outs[0]
        if outs:
            return np.concatenate(outs, axis=1)
        return np.zeros((self.batch, 0), dtype=self.np_dtype)

    # -- device-resident streaming (serving / ML-ingest path) ---------------

    @property
    def device_chunk_multiple(self) -> int | None:
        """Input-chunk granularity for :meth:`process_device`.

        The fused operator's input period for the banded steps, the factor
        for the FFT-routed decimation, 1 for the DFT upsample; ``None`` when
        the topology has data-dependent output counts (cubic, the non-exact
        walk) and only :meth:`process` is available.
        """
        return None if self._period is None else self._period[0]

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
        with span(ENGINE_PROCESS_DEVICE):
            mult = self.device_chunk_multiple
            if mult is None:
                raise NotImplementedError(
                    f"process_device: topology {self.plan.kind!r} has "
                    "data-dependent output counts; use process()")
            if self._flushed:
                raise RuntimeError(
                    "process() after flush(); call reset() first")
            if self._pending.available():
                raise RuntimeError(
                    "process_device: host-buffered input pending from a "
                    "prior process() call; feed block multiples there, or "
                    "reset()")
            x = self._to_device(x)
            if x.dim() == 1:
                x = (x.expand(self.batch, x.shape[0]) if self.batch > 1
                     else x[None, :])
            if x.shape[0] != self.batch:
                raise ValueError(
                    f"expected {self.batch} streams, got {x.shape[0]}")
            n = int(x.shape[1])
            if n % mult:
                raise ValueError(
                    f"process_device chunk width {n} is not a multiple of "
                    f"device_chunk_multiple={mult}")
            if n == 0:
                return torch.zeros((self.batch, 0), dtype=self.dtype,
                                   device=self.device)
            self.samples_in += n
            if self._head_t is not None:
                self._collect_head(x)
            return self._emit(*self._device_step(x), None)

    def _device_step(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """One step of the static-count topologies over ``x`` on the
        device: its output and the count the period gives, known on the
        host."""
        self.state, y, _n = self._step(self.state, x)
        ipx, p2 = self._period
        return y, (x.shape[1] // ipx) * p2

    def flush_device(self) -> torch.Tensor:
        """Drain all stage tails on the device; returns a tensor there.

        Device-mode counterpart of :meth:`flush`: static output counts keep
        the drain loop host-decidable, so the flush never synchronizes
        with the device either.
        """
        mult = self.device_chunk_multiple
        if mult is None:
            raise NotImplementedError(
                f"flush_device: topology {self.plan.kind!r} has "
                "data-dependent output counts; use flush()")

        def tail(z):
            # One step over the held input and the padding, rounded up to
            # the chunk multiple.
            rem = self._pending.available()
            if rem + z:
                t = np.zeros((self.batch, _ceil_div(rem + z, mult) * mult),
                             dtype=self.np_dtype)
                t[:, :rem] = self._pending.read_all()
                yield self._device_step(self._to_device(t))

        zeros = functools.cache(lambda: torch.zeros(
            (self.batch, self.block), dtype=self.dtype, device=self.device))
        outs = self._drain(tail, lambda: self._device_step(zeros()))
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
        device without downloading.  Topologies without static output
        counts (cubic, the non-exact walk) fall back to :meth:`process` and
        :meth:`flush` for ``out='host'``.
        """
        if out not in ('host', 'device'):
            raise ValueError(f"out must be 'host' or 'device', got {out!r}")
        mult = self.device_chunk_multiple
        if mult is None:
            if out == 'device':
                raise NotImplementedError(
                    f"stream(out='device'): topology {self.plan.kind!r} "
                    "has data-dependent output counts; use out='host'")
            for x in chunks:
                y = self.process(x)
                if y.shape[1]:
                    yield y
            tail = self.flush()
            if tail.shape[1]:
                yield tail
            return
        yield from pipelined_stream(self, chunks, out, mult)

    def flush(self) -> np.ndarray:
        """Drain all stage tails; returns the remaining canonical samples.

        Mirrors resampler.go:275-322 through the length model: the core is
        fed the exact zero padding that drains every stage, and the stream
        is trimmed to the canonical total.
        """
        def tail(z):
            if self._has_aa:
                # Run the flush padding through the prefilter, so the core
                # sees aa(x ++ 0^z): the prefilter's tail extends into the
                # padding (the same semantics as the fused matrix and the
                # one-shot).
                self._pending.write(self._aa_drain(z))
                z = 0
            # The held input and z zeros, rounded up to whole blocks (extra
            # zeros only produce post-canonical samples, which the limit
            # trims).
            for _ in range(_ceil_div(self._pending.available() + z,
                                     self.block)):
                yield self._run_block(self._stage_tail())

        return self._host_join(self._drain(
            tail, lambda: self._run_block(self._stage_tail())))

    # -- introspection (resample.go:339-355, resampler.go:342-353) ---------

    def get_ratio(self) -> float:
        return self.plan.ratio

    def get_latency(self) -> int:
        return self.plan.latency()

    def get_statistics(self) -> dict:
        return {"samplesIn": self.samples_in, "samplesOut": self.samples_out}
