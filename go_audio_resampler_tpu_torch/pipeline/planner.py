"""Pipeline planner: ratio -> stage decomposition.

Host copy of the JAX package's ``pipeline/planner.py``, itself a port of
the reference's ``internal/pipeline`` planner (pipeline.go:56-354):
StageType, StageSpec, QualityParams, and ``build_pipeline``, which
decomposes a resampling ratio into half-band power-of-two stages plus a
residual polyphase/FFT stage, with the same tap/phase/cutoff/
interpolation-order calculators and latency model (constants from
internal/pipeline/constants.go kept verbatim).

``api.Resampler`` realizes each planned stage as a sub-engine and fuses
runs of them into banded composites (``pipeline/fused.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import math

# Constants (internal/pipeline/constants.go)
DB_PER_BIT = 6.02
_ATT_DIVISOR = 6.0
_MIN_FILTER_TAPS = 7
_MAX_FILTER_TAPS = 127
_MIN_POLY_TAPS = 4
_MAX_POLY_TAPS = 2048
_KAISER_OFFSET = 8.0
_KAISER_MULT = 2.285
_KAISER_TWO_PI = 2.0 * math.pi
_SIMD_ALIGN = 4
_SIMD_ALIGN_MASK = 3
HALF_RATIO = 0.5
DOUBLE_RATIO = 2.0
_RATIO_TOL = 0.001
_RATIO_TOL_FFT = 0.0001
_PHASES_BASE = 64
_PHASES_24BIT = 256
_PHASES_32BIT = 1024
_FFT_SIZE_BASE = 1024
_FFT_SIZE_24BIT = 4096
_FFT_SIZE_32BIT = 8192
_LATENCY_CUBIC = 2
_LATENCY_HALFBAND = 2
_LATENCY_POLYPHASE = 2
_LATENCY_FFT = 4

COMMON_AUDIO_RATIOS = (
    44100.0 / 48000.0, 48000.0 / 44100.0,
    44100.0 / 88200.0, 88200.0 / 44100.0,
    48000.0 / 96000.0, 96000.0 / 48000.0,
)


class StageType(enum.IntEnum):
    """Processing stage kinds (pipeline.go:56-73)."""

    CUBIC = 0
    HALF_BAND = 1
    POLYPHASE = 2
    FFT = 3
    DELAY = 4


@dataclasses.dataclass
class StageSpec:
    """Parameters for creating one pipeline stage (pipeline.go:76-84)."""

    type: StageType
    ratio: float
    quality: int = 0            # precision bits
    filter_length: int = 0
    phases: int = 0
    cutoff_factor: float = 0.0
    interpolation: int = 0


@dataclasses.dataclass
class QualityParams:
    """Quality inputs for pipeline construction (pipeline.go:93-100)."""

    precision: int
    passband_end: float
    stopband_begin: float
    phase_response: float = 50.0
    allow_aliasing: bool = False


@dataclasses.dataclass
class Pipeline:
    """Planned multi-stage pipeline (pipeline.go:86-91)."""

    stages: list
    total_ratio: float
    total_latency: int = 0


class PipelineError(ValueError):
    pass


def calculate_half_band_taps(quality: QualityParams) -> int:
    """~4 taps per 6 dB of attenuation, odd, bounded (pipeline.go:236-254)."""
    attenuation = quality.precision * DB_PER_BIT
    taps = int(attenuation / _ATT_DIVISOR) * _SIMD_ALIGN
    if taps % 2 == 0:
        taps += 1
    return max(_MIN_FILTER_TAPS, min(_MAX_FILTER_TAPS, taps))


def calculate_polyphase_taps(ratio: float, quality: QualityParams) -> int:
    """Kaiser-formula tap estimate, /ratio for decimation, SIMD-rounded
    (pipeline.go:256-281)."""
    attenuation = quality.precision * DB_PER_BIT
    transition = quality.stopband_begin - quality.passband_end
    taps = int((attenuation - _KAISER_OFFSET)
               / (_KAISER_MULT * transition * _KAISER_TWO_PI))
    if ratio < 1:
        taps = int(taps / ratio)
    taps = max(_MIN_POLY_TAPS, min(_MAX_POLY_TAPS, taps))
    return (taps + _SIMD_ALIGN_MASK) & ~_SIMD_ALIGN_MASK


def calculate_polyphase_phases(quality: QualityParams) -> int:
    """64/256/1024 phases by precision (pipeline.go:283-295)."""
    phases = _PHASES_BASE
    if quality.precision >= 24:
        phases = _PHASES_24BIT
    if quality.precision >= 32:
        phases = _PHASES_32BIT
    return phases


def calculate_cutoff_factor(ratio: float, quality: QualityParams) -> float:
    """Passband end scaled by ratio when decimating (pipeline.go:297-307)."""
    cutoff = quality.passband_end
    if ratio < 1:
        cutoff *= ratio
    return cutoff


def calculate_interpolation_order(quality: QualityParams) -> int:
    """cubic >=24 bit, linear >=16 bit, none below (pipeline.go:309-318)."""
    if quality.precision >= 24:
        return 3
    if quality.precision >= 16:
        return 1
    return 0


def should_use_fft(ratio: float, quality: QualityParams) -> bool:
    """FFT for >=28-bit precision or near-common audio fractions
    (pipeline.go:320-334)."""
    if quality.precision >= 28:
        return True
    return any(abs(ratio - c) < _RATIO_TOL_FFT for c in COMMON_AUDIO_RATIOS)


def calculate_fft_size(ratio: float, quality: QualityParams) -> int:
    """Power-of-two FFT size by precision (pipeline.go:336-354)."""
    base = _FFT_SIZE_BASE
    if quality.precision >= 24:
        base = _FFT_SIZE_24BIT
    if quality.precision >= 32:
        base = _FFT_SIZE_32BIT
    size = 1
    while size < base:
        size *= 2
    return size


def build_pipeline(ratio: float, quality: QualityParams) -> Pipeline:
    """Decompose a ratio into pipeline stages (pipeline.go:104-183).

    - precision <= 8: single cubic stage
    - ratio < 0.5: repeated half-band x0.5 stages
    - ratio > 2:   repeated half-band x2 stages
    - residual != 1: FFT stage if should_use_fft else polyphase stage
    """
    if not (ratio > 0):
        raise PipelineError(f"invalid ratio: {ratio}")

    stages: list[StageSpec] = []
    if quality.precision <= 8:
        p = Pipeline(stages=[StageSpec(type=StageType.CUBIC, ratio=ratio)],
                     total_ratio=ratio)
        p.total_latency = _calculate_latency(p)
        return p

    remaining = ratio
    if ratio < 1.0:
        while remaining < HALF_RATIO:
            stages.append(StageSpec(
                type=StageType.HALF_BAND, ratio=HALF_RATIO,
                quality=quality.precision,
                filter_length=calculate_half_band_taps(quality)))
            remaining *= DOUBLE_RATIO
    if ratio > 1.0:
        while remaining > DOUBLE_RATIO:
            stages.append(StageSpec(
                type=StageType.HALF_BAND, ratio=DOUBLE_RATIO,
                quality=quality.precision,
                filter_length=calculate_half_band_taps(quality)))
            remaining /= DOUBLE_RATIO

    if abs(remaining - 1.0) > _RATIO_TOL:
        if should_use_fft(remaining, quality):
            stages.append(StageSpec(
                type=StageType.FFT, ratio=remaining,
                quality=quality.precision,
                filter_length=calculate_fft_size(remaining, quality)))
        else:
            stages.append(StageSpec(
                type=StageType.POLYPHASE, ratio=remaining,
                quality=quality.precision,
                filter_length=calculate_polyphase_taps(remaining, quality),
                phases=calculate_polyphase_phases(quality),
                cutoff_factor=calculate_cutoff_factor(remaining, quality),
                interpolation=calculate_interpolation_order(quality)))

    p = Pipeline(stages=stages, total_ratio=ratio)
    p.total_latency = _calculate_latency(p)
    return p


def _calculate_latency(p: Pipeline) -> int:
    """Cumulative latency model (pipeline.go:186-217)."""
    total = 0
    cumulative = 1.0
    for spec in p.stages:
        if spec.type == StageType.CUBIC:
            lat = _LATENCY_CUBIC
        elif spec.type == StageType.HALF_BAND:
            lat = spec.filter_length // _LATENCY_HALFBAND
        elif spec.type == StageType.POLYPHASE:
            lat = spec.filter_length // _LATENCY_POLYPHASE
        elif spec.type == StageType.FFT:
            lat = spec.filter_length // _LATENCY_FFT
        else:
            lat = spec.filter_length
        total += int(lat / cumulative)
        cumulative *= spec.ratio
    return total


def optimize_pipeline(p: Pipeline) -> Pipeline:
    """Stage-combining optimization hook (pipeline.go:361-366: identity)."""
    return p
