"""Public API: configuration, quality model, and the pipeline-path Resampler.

PyTorch counterpart of the JAX package's ``api.py``, the reference's
``package resampler`` surface:

- ``QualityPreset``/``QualitySpec``/``QualityFlags``/``get_preset_spec``
  <-> resample.go:77-153,217-267
- ``Config`` + validation       <-> resample.go:46-214
- errors                        <-> resample.go:156-165
- ``Resampler`` (pipeline path) <-> constantRateResampler (constant.go:16-485)
- ``new_resampler``             <-> New (resample.go:272-292)
- ``Info``/``get_info``         <-> resample.go:295-355

Channel parallelism: the reference runs one goroutine per channel
(constant.go:224-241); here every channel rides the leading batch axis of
one engine step, so ``process_multi`` is always "parallel"
(``enable_parallel`` is accepted for compatibility and is a no-op).

Where the engines run: ``Config.device``, 'cuda' by default (the card's
kernels; raises without a GPU), or 'cpu' (their plain versions).  The
compute dtype defaults to :func:`default_dtype` of the device: float32 on
the card, as the JAX package computes on a TPU, and float64 on the CPU,
as it computes there under x64.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import os

import numpy as np
import torch

from .engine import EngineCore, plan_engine
from .engine.plan import MIN_RATIO, MAX_RATIO
from .filterdesign import Quality as EngineQuality
from .pipeline import StageSpec, StageType, QualityParams, build_pipeline
from .pipeline.fused import BandedPlan, fuse_chain

# --- constants (constants.go) ---------------------------------------------

STEREO_CHANNELS = 2
MAX_CHANNELS = 256
ESTIMATE_OUTPUT_MARGIN = 64


class QualityPreset(enum.IntEnum):
    """Predefined quality levels (resample.go:104-131)."""

    QUICK = 0
    LOW = 1
    MEDIUM = 2
    HIGH = 3
    VERY_HIGH = 4
    CUSTOM = 5


class QualityFlags(enum.IntFlag):
    """Additional quality options (resample.go:134-153).

    Only ALLOW_ALIASING is consumed by the planner (pipeline_builder.go:32);
    NO_SIMD has no meaning here (the card's kernels and PyTorch's always
    vectorize) and is accepted for compatibility.
    """

    NONE = 0
    NO_INTERPOLATION = 1 << 0
    MINIMUM_PHASE = 1 << 1
    LINEAR_PHASE = 1 << 2
    ALLOW_ALIASING = 1 << 3
    NO_SIMD = 1 << 4


class ResamplerError(Exception):
    """Base class for resampler errors."""


class InvalidConfigError(ResamplerError, ValueError):
    """ErrInvalidConfig analog (resample.go:158)."""


class BufferTooSmallError(ResamplerError, ValueError):
    """ErrBufferTooSmall analog (resample.go:161): raised *before* any
    state advances, so the caller can retry with a larger buffer."""


class NotSupportedError(ResamplerError):
    """ErrNotSupported analog (resample.go:164)."""


# Preset parameter tables (constants.go:21-45)
_PRESET_PARAMS = {
    QualityPreset.QUICK: (8, 0.7, 1.0),
    QualityPreset.LOW: (16, 0.80, 0.95),
    QualityPreset.MEDIUM: (16, 0.90, 0.98),
    QualityPreset.HIGH: (24, 0.95, 0.99),
    QualityPreset.VERY_HIGH: (32, 0.99, 0.995),
}
_LINEAR_PHASE_RESPONSE = 50.0


@dataclasses.dataclass
class QualitySpec:
    """Resampling quality parameters (resample.go:77-102)."""

    preset: QualityPreset = QualityPreset.MEDIUM
    precision: int = 0
    phase_response: float = _LINEAR_PHASE_RESPONSE
    passband_end: float = 0.0
    stopband_begin: float = 0.0
    flags: QualityFlags = QualityFlags.NONE

    def validate(self) -> None:
        """resample.go:194-214 (custom presets only)."""
        if self.preset == QualityPreset.CUSTOM:
            if not (8 <= self.precision <= 33):
                raise InvalidConfigError("precision must be 8-33 bits")
            if not (0 <= self.phase_response <= 100):
                raise InvalidConfigError("phase response must be 0-100")
            if not (0 < self.passband_end < 1):
                raise InvalidConfigError("passband end must be in (0, 1)")
            if not (self.passband_end < self.stopband_begin <= 1):
                raise InvalidConfigError(
                    "stopband begin must be in (passband_end, 1]")


def get_preset_spec(preset: QualityPreset) -> QualitySpec:
    """Expand a preset into a full QualitySpec (resample.go:217-267)."""
    preset = QualityPreset(preset)
    if preset in _PRESET_PARAMS:
        precision, pb, sb = _PRESET_PARAMS[preset]
        return QualitySpec(preset=preset, precision=precision,
                           phase_response=_LINEAR_PHASE_RESPONSE,
                           passband_end=pb, stopband_begin=sb)
    return QualitySpec(preset=QualityPreset.MEDIUM)




def default_dtype(device='cuda'):
    """The compute dtype of ``device``: float32 on the card (the type its
    kernels take, as the JAX package computes on a TPU), float64 on the
    CPU (as the JAX package computes there under x64)."""
    return np.float32 if torch.device(device).type == 'cuda' else np.float64


@dataclasses.dataclass
class Config:
    """Resampling configuration (resample.go:46-73).

    ``enable_simd``/``enable_parallel`` are accepted for API parity; the
    compute is always vectorized and channels are always batched.
    ``dtype`` is the compute precision (default :func:`default_dtype` of
    ``device``: float32 on the card, float64 on the CPU).  ``device`` is
    where every engine runs: 'cuda' (the default; raises without a GPU)
    or 'cpu'.
    """

    input_rate: float
    output_rate: float
    channels: int = 1
    quality: QualitySpec = dataclasses.field(default_factory=QualitySpec)
    max_input_size: int = 0
    enable_simd: bool = True
    enable_parallel: bool = False
    dtype: object = None
    # Extension (beyond the reference): a delay-compensated 1:1
    # anti-alias prefilter before the chain for non-integer downsampling,
    # raising alias rejection from ~0-10 dB (reference behavior) to
    # 150-198 dB at no passband/THD/latency cost.  None = auto: engaged
    # for non-integer downsampling at >= 24-bit precision (High/VeryHigh)
    # unless QualityFlags.ALLOW_ALIASING is set; pass False for strict
    # reference parity, True to force it at any preset.
    strict_antialias: bool | None = None
    # Extension: the lowering of each engine's fused banded steps —
    # 'auto' and 'pallas' (the card's kernel), 'xla' (its plain PyTorch
    # version), or 'tune' (each engine times both on the card when it is
    # built and pins the faster; 'auto' off the card).
    dispatch: str = 'auto'
    # Extension: the matmul precision tier of each engine — 'auto'
    # (process-global GAR_TPU_MATMUL_PRECISION), 'highest' (float32-
    # accurate), 'high' (three bf16 passes), 'default' (one bf16 pass).
    precision: str = 'auto'
    # Extension (beyond reference): high-quality inter-phase mode for
    # non-exact-ratio stages — corrects the reference's phase-bank
    # boundary wrap and densifies the banks 8x, dropping the general
    # walk's THD to the filter's own floor.  Default False = bit-exact
    # reference parity.
    hq_interp: bool = False
    # Port extension: the device every engine runs on.
    device: object = 'cuda'

    def validate(self) -> None:
        """resample.go:168-191, and the port's ``device``."""
        if (not math.isfinite(self.input_rate)
                or not math.isfinite(self.output_rate)
                or self.input_rate <= 0 or self.output_rate <= 0):
            raise InvalidConfigError("sample rates must be positive")
        if self.channels < 1:
            raise InvalidConfigError("channels must be at least 1")
        if self.channels > MAX_CHANNELS:
            raise InvalidConfigError(f"too many channels (max {MAX_CHANNELS})")
        if self.dispatch not in ('auto', 'pallas', 'xla', 'tune'):
            raise InvalidConfigError(
                f"dispatch must be auto|pallas|xla|tune, "
                f"got {self.dispatch!r}")
        if self.precision not in ('auto', 'highest', 'high', 'default'):
            raise InvalidConfigError(
                f"precision must be auto|highest|high|default, "
                f"got {self.precision!r}")
        try:
            torch.device(self.device)
        except (RuntimeError, TypeError) as err:
            raise InvalidConfigError(f"bad device {self.device!r}: {err}")
        ratio = self.output_rate / self.input_rate
        if ratio < MIN_RATIO or ratio > MAX_RATIO:
            raise InvalidConfigError(
                f"resampling ratio out of range ({MIN_RATIO} to {MAX_RATIO})")
        self.quality.validate()


@dataclasses.dataclass
class Info:
    """Implementation info (resample.go:295-316).  The SIMD fields name
    the device the engines run on."""

    algorithm: str
    filter_length: int
    phases: int
    latency: int
    memory_usage: int
    simd_enabled: bool
    simd_type: str


# --- stage construction (stages.go:21-119) ---------------------------------

def precision_to_engine_quality(precision: int) -> EngineQuality:
    """Bit precision -> engine quality (stages.go:76-108)."""
    if precision <= 8:
        return EngineQuality.QUICK
    if precision <= 16:
        return EngineQuality.LOW
    if precision <= 20:
        return EngineQuality.HIGH
    if precision <= 24:
        return EngineQuality.BITS_24
    if precision <= 28:
        return EngineQuality.VERY_HIGH
    return EngineQuality.BITS_32


class StubEngine:
    """Nearest-neighbor fallback stage (stages.go:122-189 ``stubStage``).

    Used only when a polyphase sub-engine cannot be constructed for a
    stage's ratio; resamples by index mapping with no filtering, on the
    host.  Matches the reference contract: pass-through ratio adjustment,
    empty flush, zero state.
    """

    def __init__(self, ratio: float, batch: int, dtype):
        self.ratio = float(ratio)
        self.batch = batch
        self.dtype = np.dtype(dtype)
        self.samples_in = 0
        self.samples_out = 0

    def process(self, frames: np.ndarray) -> np.ndarray:
        n = frames.shape[1]
        self.samples_in += n
        out_n = int(n * self.ratio)
        if out_n == 0 or n == 0:
            return np.zeros((frames.shape[0], 0), dtype=self.dtype)
        src = np.minimum((np.arange(out_n) / self.ratio).astype(np.int64),
                         n - 1)
        self.samples_out += out_n
        return np.ascontiguousarray(frames[:, src], dtype=self.dtype)

    def flush(self) -> np.ndarray:
        return np.zeros((self.batch, 0), dtype=self.dtype)

    def reset(self) -> None:
        self.samples_in = 0
        self.samples_out = 0

    def get_ratio(self) -> float:
        return self.ratio

    def get_latency(self) -> int:
        return 0

    def estimate_output(self, n: int) -> int:
        return int(n * self.ratio) + 1

    def get_statistics(self) -> dict:
        return {"samplesIn": self.samples_in, "samplesOut": self.samples_out}


def _stage_engine(spec: StageSpec, channels: int, block: int, dtype,
                  strict_antialias: bool = False, dispatch: str = 'auto',
                  precision: str = 'auto', hq_interp: bool = False,
                  device='cuda'):
    """Create the sub-engine realizing a StageSpec (stages.go:21-119).

    Half-band stages are polyphase engines with factor 2 (stages.go:31-44);
    the FFT stage delegates to polyphase (stages.go:114-119); reference
    rates are 48000-based — only the ratio matters (stages.go:59-62).
    If the engine cannot be planned for this ratio, fall back to the
    nearest-neighbor StubEngine (stages.go:36-43).
    """
    kw = dict(batch=channels, block=block, dtype=dtype, dispatch=dispatch,
              precision=precision, device=device)
    if spec.type == StageType.CUBIC:
        plan = plan_engine(48000.0, 48000.0 * spec.ratio, EngineQuality.QUICK)
        return EngineCore(plan, **kw)
    q = precision_to_engine_quality(spec.quality)
    try:
        plan = plan_engine(48000.0, 48000.0 * spec.ratio, q,
                           strict_antialias, hq_interp)
    except (ValueError, ZeroDivisionError):
        return StubEngine(spec.ratio, channels, dtype)
    return EngineCore(plan, **kw)


_QUEUED = ("host-queued output pending from a prior process call; drain it "
           "via process_multi first, or reset()")


class Resampler:
    """Constant-rate multi-stage pipeline resampler (constant.go:16-485).

    Built by :func:`new_resampler`; holds one chain of sub-engines with all
    channels batched on the leading axis.  ``process`` mirrors the
    reference's mono path; ``process_multi`` processes all channels in one
    engine step per stage; ``process_multi_device`` keeps input and output
    on the engines' device.
    """

    def __init__(self, config: Config):
        config.validate()
        if config.quality.preset != QualityPreset.CUSTOM:
            # Expand the named preset but preserve caller-set flags:
            # flags (e.g. ALLOW_ALIASING) compose with presets in the
            # reference (resample.go:134-153) and must survive expansion.
            flags = config.quality.flags
            config.quality = get_preset_spec(config.quality.preset)
            config.quality.flags = flags
        self.config = config
        self.device = torch.device(config.device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("Resampler: CUDA is not available; pass "
                               "Config(device='cpu') to run on the CPU")
        self.ratio = config.output_rate / config.input_rate
        qp = QualityParams(
            precision=config.quality.precision,
            passband_end=config.quality.passband_end,
            stopband_begin=config.quality.stopband_begin,
            phase_response=config.quality.phase_response,
            allow_aliasing=bool(config.quality.flags
                                & QualityFlags.ALLOW_ALIASING))
        self.pipeline = build_pipeline(self.ratio, qp)
        self.dtype = np.dtype(config.dtype or default_dtype(self.device))
        block = config.max_input_size or 2048
        block = max(256, min(block, 65536))
        strict = config.strict_antialias
        if strict is None:
            # Auto mode: the reference's default non-integer downsampling
            # leaves images above the output Nyquist nearly unattenuated
            # (antialiasing_test.go:727-737, documented informational).
            # At High/VeryHigh precision the prefilter is engaged by
            # default — alias rejection is the point of those presets —
            # unless the caller opted into aliasing.
            noninteger_down = (self.ratio < 1.0
                               and not (1.0 / self.ratio).is_integer())
            strict = (noninteger_down
                      and config.quality.precision >= 24
                      and not (config.quality.flags
                               & QualityFlags.ALLOW_ALIASING))
        self._engines = [
            _stage_engine(spec, config.channels, block, self.dtype,
                          strict, config.dispatch, config.precision,
                          config.hq_interp, self.device)
            for spec in self.pipeline.stages]
        # Whole-chain fusion (pipeline/fused.py): runs of stages that are
        # periodic banded operators collapse into one composite operator
        # streamed by one engine — no host hand-offs between them.  The
        # per-stage engines are kept for introspection and as the exact
        # semantic reference (GAR_TPU_FUSE_PIPELINE=0 forces them).
        self._fused = None
        self._exec = self._engines
        if (len(self._engines) >= 2
                and os.environ.get('GAR_TPU_FUSE_PIPELINE', '1') != '0'):
            self._exec = self._build_exec(block)
            if (len(self._exec) == 1
                    and getattr(self._exec[0].plan, 'kind', '') == 'banded'):
                self._fused = self._exec[0]
        self.samples_in = 0
        self.samples_out = 0
        self._flushed = False
        self._entry_mode: str | None = None  # 'mono' | 'multi' guard
        self._out_queue = np.zeros((self.config.channels, 0),
                                   dtype=self.dtype)

    # -- core single/multi channel processing ------------------------------

    def _build_exec(self, block: int) -> list:
        """Collapse maximal runs of banded-representable stages.

        Greedy longest-run-first segmentation: every run of >= 2
        consecutive stages whose plans compose into one periodic banded
        operator (pipeline/fused.py) is replaced by a single composite
        EngineCore.  When a stage blocks fusion (e.g. a non-exact-rational
        residual, or a composite width past the memory guard) the exact
        half-band runs around it still fuse, so the host hand-offs drop
        from one per stage to one per segment.
        """
        engines = self._engines
        exec_chain: list = []
        i = 0
        while i < len(engines):
            fused_seg = None
            if isinstance(engines[i], EngineCore):
                for j in range(len(engines), i + 1, -1):
                    if not all(isinstance(e, EngineCore)
                               for e in engines[i:j]):
                        continue
                    op = fuse_chain([e.plan for e in engines[i:j]])
                    if op is None:
                        continue
                    ratio = 1.0
                    for e in engines[i:j]:
                        ratio *= float(e.plan.ratio)
                    latency = sum(e.get_latency() for e in engines[i:j])
                    bplan = BandedPlan(op, ratio, latency=latency)
                    fused_seg = (EngineCore(
                        bplan, batch=self.config.channels, block=block,
                        dtype=self.dtype, dispatch=self.config.dispatch,
                        precision=self.config.precision,
                        device=self.device), j)
                    break
            if fused_seg is not None:
                exec_chain.append(fused_seg[0])
                i = fused_seg[1]
            else:
                exec_chain.append(engines[i])
                i += 1
        return exec_chain

    def _chain(self, frames: np.ndarray) -> np.ndarray:
        """Push frames through the stage chain (constant.go:255-293): each
        execution segment (fused run or single stage engine) in turn."""
        cur = frames
        for eng in self._exec:
            cur = eng.process(cur)
        return cur

    def _check_not_flushed(self):
        if self._flushed:
            raise ResamplerError("resampler already flushed; call reset()")

    def _enter(self, mode: str):
        """Forbid interleaving mono broadcast and per-channel streams.

        With channels > 1 the mono path broadcasts to every lane, so mixing
        it with ``process_multi`` would silently corrupt all channels (the
        reference advances only channel 0's chain); raise instead."""
        if self.config.channels > 1:
            if self._entry_mode is not None and self._entry_mode != mode:
                raise ResamplerError(
                    f"cannot mix process ({mode!r}) with prior "
                    f"{self._entry_mode!r} calls on a multi-channel "
                    "resampler; call reset() first")
            self._entry_mode = mode

    def _process_raw(self, x: np.ndarray) -> np.ndarray:
        self._check_not_flushed()
        self._enter('mono')
        if x.ndim != 1:
            raise InvalidConfigError("process expects a 1-D mono array")
        self.samples_in += len(x)
        frames = np.broadcast_to(x, (self.config.channels, len(x)))
        return self._chain(np.ascontiguousarray(frames))

    def process(self, x) -> np.ndarray:
        """Resample a mono channel (resample.go:14-22).

        On a multi-channel resampler the input is broadcast to every
        channel and channel 0 is returned (documented deviation: the
        reference advances only channel 0's chain; batched state advances
        all lanes together).  Interleaving ``process`` and
        ``process_multi`` on a multi-channel resampler raises
        :class:`ResamplerError` — the mix would silently corrupt every
        channel's stream.
        """
        x = np.asarray(x, dtype=self.dtype)
        out = self._take(self._process_raw(x), None)
        self.samples_out += out.shape[1]
        return out[0]

    def process_float32(self, x) -> np.ndarray:
        """float32 entry point (resample.go:20-22, constant.go:128-158)."""
        y = self.process(np.asarray(x, dtype=np.float32))
        return y.astype(np.float32)

    def process_multi(self, channels) -> list:
        """Process all channels batched in one engine step per stage
        (constant.go:204-253; replaces goroutine-per-channel)."""
        self._check_not_flushed()
        self._enter('multi')
        arrs = [np.asarray(c, dtype=self.dtype) for c in channels]
        if len(arrs) != self.config.channels:
            raise InvalidConfigError(
                f"expected {self.config.channels} channels, got {len(arrs)}")
        n = len(arrs[0])
        if any(len(a) != n for a in arrs):
            raise InvalidConfigError(
                "all channels must have equal length per call "
                "(batched channel processing)")
        self.samples_in += n
        fresh = self._chain(np.stack(arrs)) if n else \
            np.zeros((self.config.channels, 0), dtype=self.dtype)
        out = self._take(fresh, None)
        self.samples_out += out.shape[1]
        return [out[i] for i in range(out.shape[0])]

    # -- device-resident path (serving / ML-ingest) -------------------------

    @property
    def device_chunk_multiple(self) -> int | None:
        """Input-chunk granularity for :meth:`process_multi_device`.

        ``None`` when the device path is unavailable for this pipeline
        (the exec chain did not fuse into one static-output-count
        engine); then only the host-returning methods apply.
        """
        if len(self._exec) != 1 or not isinstance(self._exec[0], EngineCore):
            return None
        return self._exec[0].device_chunk_multiple

    def _device_engine(self) -> EngineCore:
        mult = self.device_chunk_multiple
        if mult is None:
            raise NotImplementedError(
                "device mode needs the pipeline fused into ONE static-"
                "output-count engine; this chain has "
                f"{len(self._exec)} execution segment(s) "
                f"(kinds: {[getattr(e.plan, 'kind', '?') for e in self._exec]}). "
                "Use process_multi(), or a config whose stages fuse "
                "(GAR_TPU_FUSE_PIPELINE=1 is the default).")
        return self._exec[0]

    def process_multi_device(self, frames) -> torch.Tensor:
        """Resample all channels on the device; returns a tensor there.

        The serving-path twin of :meth:`process_multi`
        (``EngineCore.process_device``): ``frames`` is (or is uploaded to)
        a ``[channels, n]`` tensor on the engines' device, the whole chunk
        runs as one step, and the ``[channels, n_out]`` output stays on
        the device with no host synchronization — the caller chains
        further device work or downloads at its own cadence.  Requires
        the fully fused pipeline (the default for the standard ratios)
        and ``n`` a multiple of :attr:`device_chunk_multiple`.  May be
        mixed with the host methods only while no host output is queued.
        """
        self._check_not_flushed()
        # Validate BEFORE latching the entry mode: a chain that cannot run
        # on the device must not poison later host-path calls.
        eng = self._device_engine()
        if self._out_queue.shape[1]:
            raise ResamplerError(_QUEUED)
        self._enter('multi')
        frames = torch.as_tensor(frames).to(device=eng.device,
                                            dtype=eng.dtype)
        if frames.dim() != 2 or frames.shape[0] != self.config.channels:
            raise InvalidConfigError(
                f"expected [channels={self.config.channels}, n] frames, "
                f"got shape {tuple(frames.shape)}")
        y = eng.process_device(frames)
        self.samples_in += int(frames.shape[1])
        self.samples_out += int(y.shape[1])   # static count — no sync
        return y

    def flush_multi_device(self) -> torch.Tensor:
        """Drain all tails on the device; device-mode twin of
        :meth:`flush_multi` (one ``[channels, n_tail]`` tensor)."""
        eng = self._device_engine()
        if self._out_queue.shape[1]:
            raise ResamplerError(_QUEUED)
        if self._flushed:
            return torch.zeros((self.config.channels, 0), dtype=eng.dtype,
                               device=eng.device)
        self._flushed = True
        y = eng.flush_device()
        self.samples_out += int(y.shape[1])
        return y

    def stream_multi(self, chunks, out: str = 'host'):
        """Pipelined streaming over an iterable of ``[channels, n]`` chunks.

        Generator twin of :meth:`process_multi` + :meth:`flush_multi`
        with upload, compute and download overlapped
        (``EngineCore.stream``): the download of chunk k waits until
        chunk k+1's step has been queued, so the host loop never
        serializes transfer against compute the way the reference's
        synchronous CLI loop does (cmd/resample-wav/main.go:270-339).
        Yields ``[channels, n_out]`` arrays in stream order, ending with
        the flush tail; once the generator is exhausted the resampler is
        flushed (``reset()`` to reuse; abandoning the generator
        mid-iteration leaves the stream mid-flight).  ``out='device'``
        yields tensors on the device without downloading (fused
        device-mode chains only).
        """
        # Validate EAGERLY (this is not the generator): a bad call fails
        # at call time, not at the first next().
        if out not in ('host', 'device'):
            raise ValueError(f"out must be 'host' or 'device', got {out!r}")
        self._check_not_flushed()
        if self._out_queue.shape[1]:
            raise ResamplerError(_QUEUED)
        fused = (len(self._exec) == 1
                 and isinstance(self._exec[0], EngineCore))
        if not fused and out == 'device':
            self._device_engine()     # raises the diagnostic error
        return self._stream_multi_gen(chunks, out, fused)

    def _stream_multi_gen(self, chunks, out: str, fused: bool):
        def _check(x) -> np.ndarray:
            x = np.asarray(x, dtype=self.dtype)
            if x.ndim != 2 or x.shape[0] != self.config.channels:
                raise InvalidConfigError(
                    f"expected [channels={self.config.channels}, n] "
                    f"chunks, got shape {x.shape}")
            return x

        if fused:
            eng = self._exec[0]
            self._enter('multi')

            def _feed():
                for x in chunks:
                    x = _check(x)
                    self.samples_in += x.shape[1]
                    yield x

            for y in eng.stream(_feed(), out=out):
                self.samples_out += int(y.shape[1])
                yield y
            self._flushed = True
            return
        self._enter('multi')
        for x in chunks:
            y = np.stack(self.process_multi(list(_check(x))))
            if y.shape[1]:
                yield y
        tail = np.stack(self.flush_multi())
        if tail.shape[1]:
            yield tail

    # -- into variants (constant.go:103-199) --------------------------------

    def estimate_output(self, n_in: int) -> int:
        """Upper bound on output samples: floor(n*ratio) + 64
        (constant.go:117-119)."""
        return int(n_in * self.ratio) + ESTIMATE_OUTPUT_MARGIN

    def _take(self, fresh: np.ndarray, limit: int | None) -> np.ndarray:
        """Prepend queued output; hold back anything beyond ``limit``.

        Keeps the estimate_output contract for process_into even though the
        engine drains whole blocks (see convenience._SimpleBase)."""
        avail = np.concatenate([self._out_queue, fresh], axis=1)
        if limit is None or avail.shape[1] <= limit:
            self._out_queue = np.zeros((avail.shape[0], 0), dtype=self.dtype)
            return avail
        self._out_queue = avail[:, limit:]
        return avail[:, :limit]

    def process_into(self, x, out: np.ndarray) -> int:
        """Resample into a caller buffer; BufferTooSmallError *before* any
        state advances (constant.go:103-126).  A buffer of
        estimate_output(len(x)) samples is always sufficient; excess
        output is queued for the next call."""
        x = np.asarray(x, dtype=self.dtype)
        required = self.estimate_output(len(x))
        if out.shape[-1] < required:
            raise BufferTooSmallError(
                f"output buffer {out.shape[-1]} < required {required}")
        y = self._take(self._process_raw(x), int(out.shape[-1]))[0]
        self.samples_out += len(y)
        out[..., :len(y)] = y
        return len(y)

    def process_float32_into(self, x, out: np.ndarray) -> int:
        x = np.asarray(x, dtype=np.float32)
        required = self.estimate_output(len(x))
        if out.shape[-1] < required:
            raise BufferTooSmallError(
                f"output buffer {out.shape[-1]} < required {required}")
        y = self._take(self._process_raw(x.astype(self.dtype)),
                       int(out.shape[-1]))[0].astype(np.float32)
        self.samples_out += len(y)
        out[..., :len(y)] = y
        return len(y)

    # -- flush / reset ------------------------------------------------------

    def _flush_all(self) -> np.ndarray:
        """Front-to-back tail propagation (constant.go:349-389; the
        reference's flush_multistage_test.go:26): flush stage i, push its
        tail through stages i+1.., repeat.  The
        fused composite drains in one step (its count model folds the
        per-stage flush semantics exactly)."""
        self._flushed = True
        outs = []
        n = len(self._exec)
        for i in range(n):
            tail = self._exec[i].flush()
            for j in range(i + 1, n):
                tail = self._exec[j].process(tail)
            outs.append(tail)
        if not outs:
            outs = [np.zeros((self.config.channels, 0), dtype=self.dtype)]
        return self._take(np.concatenate(outs, axis=1), None)

    def flush(self) -> np.ndarray:
        """Drain remaining samples for the mono path (resample.go:28-32)."""
        out = self._flush_all()
        self.samples_out += out.shape[1]
        return out[0]

    def flush_multi(self) -> list:
        """MultiFlusher.FlushMulti analog (resample.go:324-329)."""
        out = self._flush_all()
        self.samples_out += out.shape[1]
        return [out[i] for i in range(out.shape[0])]

    def reset(self) -> None:
        """Clear all state (constant.go:429-444)."""
        for eng in self._engines:
            eng.reset()
        for eng in self._exec:
            if eng not in self._engines:
                eng.reset()
        self.samples_in = 0
        self.samples_out = 0
        self._flushed = False
        self._entry_mode = None
        self._out_queue = np.zeros((self.config.channels, 0),
                                   dtype=self.dtype)

    # -- introspection ------------------------------------------------------

    def get_ratio(self) -> float:
        return self.ratio

    def get_latency(self) -> int:
        """Total pipeline latency in input samples (constant.go:407-427)."""
        return sum(e.get_latency() for e in self._engines)

    def get_statistics(self) -> dict:
        return {"samplesIn": self.samples_in, "samplesOut": self.samples_out}

    def get_info(self) -> Info:
        """Algorithm/taps/phases/latency/memory info (constant.go:452-485)."""
        algos = [e.plan.algorithm() for e in self._engines] or ["identity"]
        filter_len = sum(e.plan.filter_length() for e in self._engines)
        phases = max((e.plan.num_phases for e in self._engines), default=0)
        mem = 0
        for e in self._engines:
            p = e.plan
            for arr in (p.pre_coeffs, p.decim_coeffs, p.bank_a, p.bank_b,
                        p.bank_c, p.bank_d):
                if arr is not None:
                    mem += arr.size * self.dtype.itemsize
        return Info(
            algorithm="+".join(algos), filter_length=filter_len,
            phases=phases, latency=self.get_latency(), memory_usage=mem,
            simd_enabled=True,
            simd_type=(f"cuda:{torch.cuda.get_device_name(self.device)}"
                       if self.device.type == 'cuda'
                       else f"torch:{self.device.type}"))


def new_resampler(config: Config) -> Resampler:
    """Create a pipeline-path resampler (New, resample.go:272-292)."""
    if config is None:
        raise InvalidConfigError("config is None")
    return Resampler(config)


def get_info(r) -> Info:
    """Info for any resampler object (resample.go:339-355)."""
    if hasattr(r, "get_info"):
        return r.get_info()
    return Info(algorithm="unknown", filter_length=0, phases=0,
                latency=getattr(r, "get_latency", lambda: 0)(),
                memory_usage=0, simd_enabled=False, simd_type="none")
