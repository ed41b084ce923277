"""Bessel / Kaiser design-time math (host-side, float64 numpy).

Everything in this module runs at build time on the host.  It emits
constant filter coefficients that the engine copies to the device; none
of this code appears on the device hot path.

Capability parity with the reference library's ``internal/mathutil``
(see the reference's internal/mathutil/bessel.go and constants.go):

- ``bessel_i0``      <-> BesselI0          (bessel.go:22-49)
- ``bessel_i1``      <-> besselI1          (bessel.go:75-106)
- ``bessel_i0_ratio``<-> BesselI0Ratio     (bessel.go:53-71)
- ``kaiser_beta``    <-> KaiserBeta        (bessel.go:126-134)
- ``kaiser_beta_with_tr_bw`` <-> KaiserBetaWithTrBw (bessel.go:151-206)
- ``kaiser_attenuation``     <-> KaiserAttenuation  (bessel.go:216-222)
- ``estimate_filter_length`` <-> EstimateFilterLength (bessel.go:245-268)

The numerical recipes are the classic Abramowitz & Stegun Chebyshev
approximations plus Kaiser & Schafer's empirical formulas and soxr's
transition-bandwidth-aware beta polynomial table; constants are kept
verbatim so filter design matches the reference bit-for-bit at the
parameter level.
"""

from __future__ import annotations

import math


def _exp(x: float) -> float:
    """exp(x) that saturates to +Inf on overflow (Go math.Exp semantics)."""
    try:
        return math.exp(x)
    except OverflowError:
        return math.inf

# Thresholds (reference: mathutil/constants.go:10-18)
_SMALL_ARG = 3.75      # |x| threshold between series and asymptotic forms
_LARGE_ARG = 50.0      # threshold for the asymptotic I1/I0 ratio
_TINY_ARG = 1e-10      # series expansion threshold in the ratio
_BETA_MIN = 0.1        # minimum beta for attenuation estimate

# Chebyshev coefficients for I0, small argument (constants.go:21-28)
_I0_SMALL = (3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.360768e-1,
             0.45813e-2)

# Chebyshev coefficients for I0, large argument (constants.go:31-41)
_I0_LARGE = (0.39894228, 0.1328592e-1, 0.225319e-2, -0.157565e-2,
             0.916281e-2, -0.2057706e-1, 0.2635537e-1, -0.1647633e-1,
             0.392377e-2)

# Chebyshev coefficients for I1, small argument (constants.go:44-52)
_I1_SMALL = (0.5, 0.87890594, 0.51498869, 0.15084934, 0.2658733e-1,
             0.301532e-2, 0.32411e-3)

# Chebyshev coefficients for I1, large argument (constants.go:55-65)
_I1_LARGE = (0.39894228, -0.3988024e-1, -0.362018e-2, 0.163801e-2,
             -0.1031555e-1, 0.2282967e-1, -0.2895312e-1, 0.1787654e-1,
             -0.420059e-2)

# Kaiser & Schafer formula constants (constants.go:69-84)
_KAISER_ATT_HIGH = 50.0
_KAISER_ATT_MEDIUM = 21.0
_KAISER_ATT_POLY = 60.0
_KAISER_MIN_TRBW = 0.0001
_KAISER_TRBW_REALM_BASE = 0.0005
_KAISER_BETA_HIGH_C1 = 0.1102
_KAISER_BETA_HIGH_OFF = 8.7
_KAISER_BETA_MED_C1 = 0.5842
_KAISER_BETA_MED_POW = 0.4
_KAISER_BETA_MED_C2 = 0.07886

# Filter length estimate constants (constants.go:87-98)
_LEN_OFFSET = 8.0
_LEN_MULT = 2.285
_LEN_PI_FACTOR = 2.0
MIN_FILTER_LENGTH = 3
MAX_FILTER_LENGTH = 8191
_DEFAULT_TRBW = 0.01

# soxr's transition-bandwidth-aware beta polynomial table
# (reference: mathutil/bessel.go:155-166; originally soxr filter.c)
# Each row: (a3, a2, a1, a0) for ((a3*att + a2)*att + a1)*att + a0.
_SOXR_BETA_COEFS = (
    (-6.784957e-10, 1.02856e-05, 0.1087556, -0.8988365 + .001),
    (-6.897885e-10, 1.027433e-05, 0.10876, -0.8994658 + .002),
    (-1.000683e-09, 1.030092e-05, 0.1087677, -0.9007898 + .003),
    (-3.654474e-10, 1.040631e-05, 0.1087085, -0.8977766 + .006),
    (8.106988e-09, 6.983091e-06, 0.1091387, -0.9172048 + .015),
    (9.519571e-09, 7.272678e-06, 0.1090068, -0.9140768 + .025),
    (-5.626821e-09, 1.342186e-05, 0.1083999, -0.9065452 + .05),
    (-9.965946e-08, 5.073548e-05, 0.1040967, -0.7672778 + .085),
    (1.604808e-07, -5.856462e-05, 0.1185998, -1.34824 + .1),
    (-1.511964e-07, 6.363034e-05, 0.1064627, -0.9876665 + .18),
)


def bessel_i0(x: float) -> float:
    """Modified Bessel function of the first kind, order zero, I0(x).

    Chebyshev approximations per Abramowitz & Stegun; ~15 digits.
    Reference parity: mathutil/bessel.go:22-49.
    """
    ax = abs(x)
    if ax < _SMALL_ARG:
        t = (x / _SMALL_ARG) ** 2
        c1, c2, c3, c4, c5, c6 = _I0_SMALL
        return 1.0 + t * (c1 + t * (c2 + t * (c3 + t * (c4 + t * (c5 + t * c6)))))
    t = _SMALL_ARG / ax
    acc = _I0_LARGE[-1]
    for c in reversed(_I0_LARGE[:-1]):
        acc = c + t * acc
    return _exp(ax) * acc / math.sqrt(ax)


def bessel_i0_array(x):
    """Vectorized I0 over a float64 numpy array.

    Same Chebyshev polynomials and evaluation order as :func:`bessel_i0`
    (elementwise results match the scalar path up to libm-vs-numpy exp/
    sqrt rounding, <=1 ulp).  Used by the long-window fast path of
    kaiser_window — the HQ inter-phase mode designs 10^4..10^5-tap
    prototypes, where the scalar per-tap loop costs seconds.
    """
    import numpy as np

    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    t_small = (x / _SMALL_ARG) ** 2
    c1, c2, c3, c4, c5, c6 = _I0_SMALL
    small = 1.0 + t_small * (c1 + t_small * (
        c2 + t_small * (c3 + t_small * (c4 + t_small * (c5 + t_small * c6)))))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        t_large = np.where(ax > 0, _SMALL_ARG / np.maximum(ax, 1e-300), 0.0)
        acc = np.full_like(t_large, _I0_LARGE[-1])
        for c in reversed(_I0_LARGE[:-1]):
            acc = c + t_large * acc
        large = np.exp(ax) * acc / np.sqrt(np.maximum(ax, 1e-300))
    return np.where(ax < _SMALL_ARG, small, large)


def bessel_i1(x: float) -> float:
    """Modified Bessel function of the first kind, order one, I1(x).

    Reference parity: mathutil/bessel.go:75-106.
    """
    ax = abs(x)
    if ax < _SMALL_ARG:
        t = (x / _SMALL_ARG) ** 2
        acc = _I1_SMALL[-1]
        for c in reversed(_I1_SMALL[:-1]):
            acc = c + t * acc
        result = ax * acc
    else:
        t = _SMALL_ARG / ax
        acc = _I1_LARGE[-1]
        for c in reversed(_I1_LARGE[:-1]):
            acc = c + t * acc
        result = _exp(ax) * acc / math.sqrt(ax)
    return -result if x < 0 else result


def bessel_i0_ratio(x: float) -> float:
    """I1(x) / I0(x), numerically stable for large x.

    Reference parity: mathutil/bessel.go:53-71.
    """
    if abs(x) < _TINY_ARG:
        return x / 2.0
    ax = abs(x)
    if ax > _LARGE_ARG:
        return 1.0 - 1.0 / (2.0 * ax)
    return bessel_i1(x) / bessel_i0(x)


def kaiser_beta(attenuation: float) -> float:
    """Kaiser window beta from stopband attenuation (dB), Kaiser & Schafer.

    Reference parity: mathutil/bessel.go:126-134.
    """
    if attenuation > _KAISER_ATT_HIGH:
        return _KAISER_BETA_HIGH_C1 * (attenuation - _KAISER_BETA_HIGH_OFF)
    if attenuation >= _KAISER_ATT_MEDIUM:
        delta = attenuation - _KAISER_ATT_MEDIUM
        return (_KAISER_BETA_MED_C1 * delta ** _KAISER_BETA_MED_POW
                + _KAISER_BETA_MED_C2 * delta)
    return 0.0


def kaiser_beta_with_tr_bw(attenuation: float, tr_bw: float) -> float:
    """Kaiser beta using soxr's transition-bandwidth-aware polynomial table.

    More accurate than :func:`kaiser_beta` for attenuation >= 60 dB.
    Reference parity: mathutil/bessel.go:151-206 (soxr lsx_kaiser_beta).
    """
    if attenuation >= _KAISER_ATT_POLY:
        tr_bw = max(tr_bw, _KAISER_MIN_TRBW)
        realm = math.log(tr_bw / _KAISER_TRBW_REALM_BASE) / math.log(2.0)
        idx0 = max(int(realm), 0)
        idx0 = min(idx0, len(_SOXR_BETA_COEFS) - 1)
        idx1 = min(idx0 + 1, len(_SOXR_BETA_COEFS) - 1)
        c0 = _SOXR_BETA_COEFS[idx0]
        c1 = _SOXR_BETA_COEFS[idx1]
        b0 = ((c0[0] * attenuation + c0[1]) * attenuation + c0[2]) * attenuation + c0[3]
        b1 = ((c1[0] * attenuation + c1[1]) * attenuation + c1[2]) * attenuation + c1[3]
        frac = realm - float(int(realm))
        if frac < 0:
            frac = 0.0
        return b0 + (b1 - b0) * frac
    return kaiser_beta(attenuation)


def kaiser_attenuation(beta: float) -> float:
    """Approximate inverse of :func:`kaiser_beta`.

    Reference parity: mathutil/bessel.go:216-222.
    """
    if beta < _BETA_MIN:
        return 0.0
    return _KAISER_BETA_HIGH_OFF + beta / _KAISER_BETA_HIGH_C1


def estimate_filter_length(attenuation: float, transition_bw: float) -> int:
    """Estimate FIR length via Kaiser's formula N ~ (att-8)/(2.285*2*pi*trBw).

    Returns an odd tap count clamped to [3, 8191].
    Reference parity: mathutil/bessel.go:245-268.
    """
    if transition_bw <= 0:
        transition_bw = _DEFAULT_TRBW
    num = (attenuation - _LEN_OFFSET) / (
        _LEN_MULT * _LEN_PI_FACTOR * math.pi * transition_bw)
    taps = int(math.ceil(num))
    if taps % 2 == 0:
        taps += 1
    return max(MIN_FILTER_LENGTH, min(MAX_FILTER_LENGTH, taps))
