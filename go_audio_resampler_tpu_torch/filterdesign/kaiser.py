"""Kaiser windowed-sinc lowpass design (host-side, float64 numpy).

Runs entirely at build time; emits constant coefficient arrays that
the engine copies to the device.

Capability parity with the reference ``internal/filter/kaiser.go``:

- ``kaiser_window``          <-> KaiserWindow          (kaiser.go:47-91)
- ``design_lowpass``         <-> DesignLowPassFilter   (kaiser.go:159-203)
- ``design_lowpass_auto``    <-> DesignLowPassFilterAuto (kaiser.go:221-233)
- ``frequency_response``     <-> ComputeFrequencyResponse (kaiser.go:260-294)
- ``magnitude_db``           <-> MagnitudeDB           (kaiser.go:297-307)
- ``FilterParams.validate``  <-> FilterParams.Validate (kaiser.go:112-138)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import bessel

MIN_FILTER_TAPS = 3
MAX_FILTER_TAPS = 8191
MAX_ATTENUATION = 500.0  # dB; beyond this I0 overflows in the window

_SINC_ZERO = 1e-10


class FilterDesignError(ValueError):
    """Raised for invalid filter design parameters."""


@dataclasses.dataclass
class FilterParams:
    """Lowpass design parameters (cutoff normalized to [0, 0.5] = Nyquist).

    Mirrors reference filter.FilterParams (kaiser.go:94-109).
    """

    num_taps: int
    cutoff_freq: float
    attenuation: float
    gain: float = 1.0

    def validate(self, max_taps: int = MAX_FILTER_TAPS) -> None:
        if self.num_taps < MIN_FILTER_TAPS:
            raise FilterDesignError(
                f"filter too short: {self.num_taps} taps (minimum {MIN_FILTER_TAPS})")
        if self.num_taps > max_taps:
            raise FilterDesignError(
                f"filter too long: {self.num_taps} taps (maximum {max_taps})")
        if not (0.0 < self.cutoff_freq < 0.5):
            raise FilterDesignError(
                f"invalid cutoff frequency: {self.cutoff_freq} (must be in (0, 0.5))")
        if self.attenuation < 0:
            raise FilterDesignError(
                f"invalid attenuation: {self.attenuation} dB (must be positive)")
        if self.attenuation > MAX_ATTENUATION:
            raise FilterDesignError(
                f"invalid attenuation: {self.attenuation} dB (max {MAX_ATTENUATION})")
        if self.gain <= 0:
            raise FilterDesignError(f"invalid gain: {self.gain} (must be positive)")


def kaiser_window(length: int, beta: float) -> np.ndarray:
    """Kaiser window w[n] = I0(beta*sqrt(1-((n-a)/a)^2)) / I0(beta).

    Symmetric; uses the exp(arg-beta) overflow fallback for extreme beta
    where both I0 evaluations are +Inf.  Reference parity: kaiser.go:47-91.
    """
    if length < 1:
        return np.zeros(0, dtype=np.float64)
    if length == 1:
        return np.ones(1, dtype=np.float64)
    beta = abs(beta)
    alpha = (length - 1) / 2.0
    i0_beta = bessel.bessel_i0(beta)
    if length > MAX_FILTER_TAPS and math.isfinite(i0_beta):
        # Long-window fast path (HQ inter-phase prototypes run to 10^5
        # taps; the scalar loop costs seconds there).  Reference-parity
        # lengths (<= 8191) keep the scalar loop bit-for-bit.
        n = np.arange(length, dtype=np.float64)
        x = (n - alpha) / alpha
        arg = beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))
        return bessel.bessel_i0_array(arg) / i0_beta
    out = np.empty(length, dtype=np.float64)
    for n in range(length):
        x = (n - alpha) / alpha
        arg = beta * math.sqrt(max(0.0, 1.0 - x * x))
        i0_arg = bessel.bessel_i0(arg)
        if math.isinf(i0_arg) and math.isinf(i0_beta):
            out[n] = math.exp(arg - beta)
        else:
            out[n] = i0_arg / i0_beta
    return out


def design_lowpass(params: FilterParams,
                   max_taps: int = MAX_FILTER_TAPS) -> np.ndarray:
    """Windowed-sinc lowpass FIR, DC gain normalized to ``params.gain``.

    Reference parity: kaiser.go:159-203.  ``max_taps`` lifts the
    reference's 8191-tap library bound for the beyond-reference HQ
    inter-phase mode (the bound mirrors libsoxr's design API, not a
    numerical constraint; the window/sinc math is length-agnostic).
    """
    params.validate(max_taps=max_taps)
    beta = bessel.kaiser_beta(params.attenuation)
    window = kaiser_window(params.num_taps, beta)
    n = np.arange(params.num_taps, dtype=np.float64)
    center = (params.num_taps - 1) / 2.0
    x = n - center
    # sinc: sin(2*pi*fc*x)/(pi*x), center tap = 2*fc
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(
            np.abs(x) < _SINC_ZERO,
            2.0 * params.cutoff_freq,
            np.sin(2.0 * math.pi * params.cutoff_freq * x) / (math.pi * x),
        )
    filt = sinc * window
    total = float(filt.sum())
    if abs(total) > _SINC_ZERO:
        filt = filt * (params.gain / total)
    return filt


def design_lowpass_auto(cutoff_freq: float, transition_bw: float,
                        attenuation: float, gain: float = 1.0) -> np.ndarray:
    """Lowpass design with automatic length from Kaiser's formula.

    Reference parity: kaiser.go:221-233.
    """
    num_taps = bessel.estimate_filter_length(attenuation, transition_bw)
    return design_lowpass(FilterParams(num_taps, cutoff_freq, attenuation, gain))


@dataclasses.dataclass
class FilterResponse:
    """DTFT frequency response samples (kaiser.go:236-245)."""

    frequencies: np.ndarray
    magnitude: np.ndarray
    phase: np.ndarray


def frequency_response(coeffs: np.ndarray, num_points: int = 512) -> FilterResponse:
    """Evaluate H(e^jw) at num_points frequencies in [0, Nyquist).

    Vectorized DTFT; reference parity: kaiser.go:260-294.
    """
    if num_points <= 0:
        num_points = 512
    coeffs = np.asarray(coeffs, dtype=np.float64)
    freqs = np.arange(num_points, dtype=np.float64) / (2.0 * num_points)
    omega = 2.0 * math.pi * freqs  # [K]
    n = np.arange(len(coeffs), dtype=np.float64)  # [N]
    angles = np.outer(omega, n)  # [K, N]
    real = np.cos(angles) @ coeffs
    imag = -(np.sin(angles) @ coeffs)
    mag = np.hypot(real, imag)
    phase = np.arctan2(imag, real)
    return FilterResponse(frequencies=freqs, magnitude=mag, phase=phase)


def magnitude_db(magnitude: float) -> float:
    """Linear magnitude to dB, floored at 1e-10 (kaiser.go:297-307)."""
    return 20.0 * math.log10(max(magnitude, 1e-10))
