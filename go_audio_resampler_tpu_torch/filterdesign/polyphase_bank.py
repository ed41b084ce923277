"""Standalone polyphase filter bank designer (host-side, float64 numpy).

Used by the ``analyze-filter`` CLI and by tests; the engine has its own
design path in :mod:`.params` (mirroring the reference's split between
``internal/filter/polyphase.go`` and ``internal/engine/filter_params.go``).

Reference parity: internal/filter/polyphase.go:67-385 —
``PolyphaseFilterBank`` with flat coefficient layout
``[tap * num_phases + phase] * (order + 1)``, interpolation orders
none/linear/cubic, a 16 taps-per-phase minimum, Horner-evaluated
``get_coefficient`` and per-bank frequency response.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from . import bessel, kaiser


class InterpolationOrder(enum.IntEnum):
    """Coefficient interpolation order between phases (polyphase.go:26-40)."""

    NONE = 0
    LINEAR = 1
    CUBIC = 3


MIN_TAPS_PER_PHASE = 16  # polyphase.go minimum


@dataclasses.dataclass
class PolyphaseFilterBank:
    """Flat-layout polyphase bank with optional coefficient interpolation.

    ``coeffs`` has shape ``[taps_per_phase * num_phases, order + 1]`` where
    entry ``[tap * num_phases + phase, k]`` is the k-th polynomial
    coefficient of that tap/phase (k=0 is the base value).
    """

    num_phases: int
    taps_per_phase: int
    interpolation: InterpolationOrder
    coeffs: np.ndarray
    cutoff: float
    attenuation: float

    def get_coefficient(self, tap: int, phase: int, frac: float) -> float:
        """Horner-evaluate the interpolated coefficient at sub-phase frac.

        Reference parity: GetCoefficient (polyphase.go:309-337).
        """
        idx = tap * self.num_phases + phase
        poly = self.coeffs[idx]
        acc = 0.0
        for c in poly[::-1]:
            acc = acc * frac + c
        return float(acc)

    def phase_response(self, phase: int, num_points: int = 512) -> kaiser.FilterResponse:
        """Frequency response of a single phase (polyphase.go:339-384)."""
        taps = np.array([self.coeffs[t * self.num_phases + phase, 0]
                         for t in range(self.taps_per_phase)])
        return kaiser.frequency_response(taps, num_points)

    def phase_dc_gain(self, phase: int) -> float:
        """DC gain of one phase (sum of its base coefficients)."""
        return float(sum(self.coeffs[t * self.num_phases + phase, 0]
                         for t in range(self.taps_per_phase)))


def design_polyphase_bank(
    num_phases: int,
    taps_per_phase: int,
    cutoff: float,
    attenuation: float,
    interpolation: InterpolationOrder = InterpolationOrder.CUBIC,
) -> PolyphaseFilterBank:
    """Design a standalone polyphase bank from a Kaiser-window prototype.

    The prototype has ``num_phases * taps_per_phase`` taps, cutoff scaled by
    ``1/num_phases`` (each phase runs at the original rate), and DC gain
    normalized so each phase has unity gain.
    Reference parity: DesignPolyphaseFilterBank (polyphase.go:157-234).
    """
    if num_phases < 1:
        raise kaiser.FilterDesignError(f"num_phases must be >= 1: {num_phases}")
    taps_per_phase = max(taps_per_phase, MIN_TAPS_PER_PHASE)
    total_taps = num_phases * taps_per_phase
    # Respect the 8191-tap library limit.
    if total_taps > kaiser.MAX_FILTER_TAPS:
        taps_per_phase = kaiser.MAX_FILTER_TAPS // num_phases
        total_taps = num_phases * taps_per_phase

    beta = bessel.kaiser_beta(attenuation)
    window = kaiser.kaiser_window(total_taps, beta)
    center = (total_taps - 1) / 2.0
    n = np.arange(total_taps, dtype=np.float64)
    x = n - center
    fc = cutoff / num_phases
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(np.abs(x) < 1e-10, 2.0 * fc,
                        np.sin(2.0 * np.pi * fc * x) / (np.pi * x))
    proto = sinc * window
    total = float(proto.sum())
    if abs(total) > 1e-10:
        proto = proto * (num_phases / total)

    order = int(interpolation)
    coeffs = np.zeros((total_taps, order + 1), dtype=np.float64)
    coeffs[:, 0] = proto

    if interpolation is not InterpolationOrder.NONE:
        def get(tap: int, phase: int) -> float:
            idx = tap * num_phases + (phase % num_phases)
            return float(proto[idx]) if 0 <= idx < total_taps else 0.0

        for tap in range(taps_per_phase):
            for phase in range(num_phases):
                f0 = get(tap, phase)
                f1 = get(tap, phase + 1)
                idx = tap * num_phases + phase
                if interpolation is InterpolationOrder.LINEAR:
                    coeffs[idx, 1] = f1 - f0
                else:  # cubic, Catmull-Rom style
                    fm1 = get(tap, phase - 1)
                    f2 = get(tap, phase + 2)
                    c = 0.5 * (f1 + fm1) - f0
                    d = (1.0 / 6.0) * (f2 - f1 + fm1 - f0 - 4.0 * c)
                    b = f1 - f0 - d - c
                    coeffs[idx, 1] = b
                    coeffs[idx, 2] = c
                    coeffs[idx, 3] = d

    return PolyphaseFilterBank(
        num_phases=num_phases, taps_per_phase=taps_per_phase,
        interpolation=interpolation, coeffs=coeffs, cutoff=cutoff,
        attenuation=attenuation)
