"""Frozen copy of the filter design that the benchmark's reference uses.

A plain float64 NumPy copy of the soxr-style design that the resampler
ports from the Go library tphakala/go-audio-resampler (``internal/filter/
kaiser.go``, ``internal/mathutil/bessel.go``, ``internal/engine/
filter_params.go``, ``internal/engine/dft_stage.go``): the Kaiser window,
the windowed-sinc lowpass, soxr's Fn/Fp/Fs normalisation and tap sizing,
the rational phase count, and the 2x DFT upsampling, decimation and
polyphase filters.  It is kept here, apart from the program, so that a
change to the program's design cannot move the yardstick: the reference
designs its filters from this file alone and imports nothing of the
program.

Only what the benchmark's configurations reach is kept: integer
decimation, and the exact-rational two-stage plan (2x prestage then the
polyphase walk), at any quality preset but QUICK.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# --- Bessel I0 and Kaiser's formulas (bessel.go) ----------------------------

_I0_SMALL = (3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.360768e-1,
             0.45813e-2)
_I0_LARGE = (0.39894228, 0.1328592e-1, 0.225319e-2, -0.157565e-2,
             0.916281e-2, -0.2057706e-1, 0.2635537e-1, -0.1647633e-1,
             0.392377e-2)
MAX_FILTER_TAPS = 8191


def bessel_i0(x: float) -> float:
    """I0(x), Abramowitz & Stegun's Chebyshev approximations."""
    ax = abs(x)
    if ax < 3.75:
        t = (x / 3.75) ** 2
        c1, c2, c3, c4, c5, c6 = _I0_SMALL
        return 1.0 + t * (c1 + t * (c2 + t * (c3 + t * (c4 + t * (
            c5 + t * c6)))))
    t = 3.75 / ax
    acc = _I0_LARGE[-1]
    for c in reversed(_I0_LARGE[:-1]):
        acc = c + t * acc
    try:
        e = math.exp(ax)
    except OverflowError:
        e = math.inf
    return e * acc / math.sqrt(ax)


def kaiser_beta(attenuation: float) -> float:
    """Kaiser & Schafer's beta for a stopband attenuation in dB."""
    if attenuation > 50.0:
        return 0.1102 * (attenuation - 8.7)
    if attenuation >= 21.0:
        delta = attenuation - 21.0
        return 0.5842 * delta ** 0.4 + 0.07886 * delta
    return 0.0


def estimate_filter_length(attenuation: float, transition_bw: float) -> int:
    """Kaiser's length estimate, odd, clamped to [3, 8191]."""
    if transition_bw <= 0:
        transition_bw = 0.01
    taps = int(math.ceil((attenuation - 8.0)
                         / (2.285 * 2.0 * math.pi * transition_bw)))
    if taps % 2 == 0:
        taps += 1
    return max(3, min(MAX_FILTER_TAPS, taps))


def kaiser_window(length: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window (the scalar loop: lengths up to 8191)."""
    if length == 1:
        return np.ones(1)
    beta = abs(beta)
    alpha = (length - 1) / 2.0
    i0_beta = bessel_i0(beta)
    out = np.empty(length)
    for n in range(length):
        x = (n - alpha) / alpha
        arg = beta * math.sqrt(max(0.0, 1.0 - x * x))
        i0_arg = bessel_i0(arg)
        if math.isinf(i0_arg) and math.isinf(i0_beta):
            out[n] = math.exp(arg - beta)
        else:
            out[n] = i0_arg / i0_beta
    return out


def design_lowpass(num_taps: int, cutoff: float, attenuation: float,
                   gain: float = 1.0) -> np.ndarray:
    """Kaiser-windowed sinc, cutoff in [0, 0.5], DC gain ``gain``."""
    if not 3 <= num_taps <= MAX_FILTER_TAPS or not 0.0 < cutoff < 0.5:
        raise ValueError(f"lowpass out of range: {num_taps} taps, cutoff "
                         f"{cutoff}")
    window = kaiser_window(num_taps, kaiser_beta(attenuation))
    x = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(np.abs(x) < 1e-10, 2.0 * cutoff,
                        np.sin(2.0 * math.pi * cutoff * x) / (math.pi * x))
    filt = sinc * window
    total = float(filt.sum())
    if abs(total) > 1e-10:
        filt = filt * (gain / total)
    return filt


def design_lowpass_auto(cutoff: float, transition_bw: float,
                        attenuation: float) -> np.ndarray:
    return design_lowpass(estimate_filter_length(attenuation, transition_bw),
                          cutoff, attenuation)


# --- Quality presets (filter_params.go) -------------------------------------

#: Bits of each preset, soxr's: QUICK 8, LOW 16, MEDIUM 16, HIGH 20,
#: VERY_HIGH 28.
QUALITY_BITS = {"QUICK": 8, "LOW": 16, "MEDIUM": 16, "HIGH": 20,
                "VERY_HIGH": 28}
#: Passband end (Fp0) as a fraction of Nyquist.
PASSBAND_END = {"QUICK": 0.67625, "LOW": 0.67625, "MEDIUM": 0.91,
                "HIGH": 0.912, "VERY_HIGH": 0.913}
#: The decimation filter's attenuation floor at HIGH and above.
DECIM_ATTENUATION_FLOOR_DB = 150.0
SOXR_DFT_STAGE_FC = 0.4778321
PHASE_FRAC_BITS = 16


def attenuation_db(quality: str) -> float:
    return (QUALITY_BITS[quality] + 1) * 6.0206


def lsx_inv_f_resp(drop: float, attenuation: float) -> float:
    """soxr filter.c's lsx_inv_f_resp."""
    a = min(max(attenuation, 1.0), 300.0)
    x = ((2.0517e-07 * a - 1.1303e-04) * a + 0.023154) * a + 0.55924
    drop_linear = math.exp(drop * math.log(10.0) * 0.05)
    s = 1.0 - drop_linear if drop_linear > 0.5 else drop_linear
    sin_val = max(math.sin(x * 0.5), 1e-10)
    sine_pow = math.log(0.5) / math.log(sin_val)
    x = math.asin(s ** (1.0 / sine_pow)) / x
    return x if drop_linear > 0.5 else 1.0 - x


def find_rational_approx(ratio: float) -> int:
    """The phase count L in [64, 256] whose step/L comes nearest
    1/ratio (80 unless another is nearer)."""
    inv = 1.0 / ratio
    best_l, best_err = 80, abs(int(round(inv * 80)) / 80 - inv)
    for l in range(64, 257):
        cand = int(round(inv * l))
        if cand <= 0:
            continue
        err = abs(cand / l - inv)
        if err < best_err:
            best_l, best_err = l, err
        if best_err < 1e-10:
            break
    return best_l


def polyphase_taps(num_phases: int, ratio: float, total_io: float,
                   has_pre: bool, attenuation: float,
                   passband_end: float) -> tuple[int, float]:
    """(taps per phase, cutoff in [0, 0.5]) of soxr's polyphase
    prototype: ComputePolyphaseFilterParams."""
    upsampling = total_io < 1.0
    mult = 1.0 if upsampling else total_io
    if upsampling:
        fp1, fs1 = total_io * passband_end, total_io
    else:
        fp1, fs1 = passband_end * ratio, ratio
    if not upsampling and has_pre:
        fn, fs_raw, fp_raw = 2.0 * mult, 3.0 + abs(fs1 - 1.0), fp1
    else:
        fn, fs_raw, fp_raw = 1.0, 2.0 - (fp1 + (fs1 - fp1) * 0.7), fp1
    inv = lsx_inv_f_resp(-0.01, attenuation)
    if inv < 0.999:
        adjusted = fs_raw - (fs_raw - fp_raw) / (1.0 - inv)
        if 0.0 < adjusted < fs_raw:
            fp_raw = adjusted
    fp, fs = fp_raw / abs(fn), fs_raw / abs(fn)
    tr_bw = min(0.5 * (fs - fp) / num_phases, 0.5 * fs / num_phases)
    tr_bw = max(tr_bw, 0.001)
    fc = max(fs / num_phases - tr_bw, 0.001)
    if attenuation < 110.0:
        max_tpp = 32
    elif attenuation < 130.0:
        max_tpp = 64
    elif attenuation < 160.0:
        max_tpp = 100
    else:
        max_tpp = 8191 // num_phases
    ideal = int(math.ceil(attenuation / tr_bw + 1))
    tpp = min(max((ideal + num_phases - 1) // num_phases, 8), max_tpp)
    if num_phases * tpp - 1 > 8190:
        tpp = max(8191 // num_phases, 8)
    return tpp, min(max(fc / 2.0, 0.001), 0.499)


# --- The stage filters -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decimation:
    """y[j] = sum_t coeffs[t] * x[j*factor + t] over the zero-extended
    input: coeffs are the prototype reversed."""
    factor: int
    coeffs: np.ndarray


@dataclasses.dataclass(frozen=True)
class TwoStage:
    """u[i*F + p] = sum_tau pre[p, tau] * xz[i + tau], xz = 0^(T1-1) x;
    then y[j] = sum_t bank[phase_j, t] * u[div_j + t] on the exact
    rational walk (both tap-reversed)."""
    factor: int
    pre: np.ndarray            # [F, T1]
    num_phases: int
    bank: np.ndarray           # [L, T2]
    step: int                  # 16-bit fixed point, no fraction


def design_upsample(factor: int, quality: str) -> np.ndarray:
    """[factor, T1] tap-reversed phases of the anti-imaging prestage,
    each scaled by ``factor``."""
    proto = design_lowpass_auto(SOXR_DFT_STAGE_FC / factor, 0.05 / factor,
                                attenuation_db(quality))
    taps = (len(proto) + factor - 1) // factor
    coeffs = np.zeros((factor, taps))
    for phase in range(factor):
        for tap in range(taps):
            idx = tap * factor + phase
            if idx < len(proto):
                coeffs[phase, taps - 1 - tap] = proto[idx] * factor
    return coeffs


def design_decimation(factor: int, quality: str) -> Decimation:
    fp = PASSBAND_END[quality] / factor
    fs = 1.0 / factor
    tr_bw = 0.5 * (fs - fp)
    att = attenuation_db(quality)
    if att >= 120.0:
        att = max(att, DECIM_ATTENUATION_FLOOR_DB)
    proto = design_lowpass_auto((fs - tr_bw) * 0.5, tr_bw * 0.5, att)
    return Decimation(factor, proto[::-1].copy())


def design_two_stage(input_rate: float, output_rate: float,
                     quality: str) -> TwoStage:
    """The 2x prestage and the polyphase walk of a non-integer ratio;
    refuses a ratio whose walk would interpolate between phases."""
    ratio = output_rate / input_rate
    poly_ratio = output_rate / (input_rate * 2)
    total_io = input_rate / output_rate
    has_pre = ratio >= 1.0
    att = attenuation_db(quality)
    num_phases = find_rational_approx(poly_ratio)
    tpp, cutoff = polyphase_taps(num_phases, poly_ratio, total_io, has_pre,
                                 att, PASSBAND_END[quality])
    proto = design_lowpass(num_phases * tpp - 1, cutoff, att)
    proto = proto * (num_phases / float(proto.sum()))
    flat = np.zeros(tpp * num_phases)
    flat[:len(proto)] = proto
    # bank[phase, T2-1-tap] = flat[tap*L + phase]: the phases at their
    # own sub-sample offset, tap-reversed.
    bank = flat.reshape(tpp, num_phases).T[:, ::-1].copy()
    step = int(round((1.0 / poly_ratio) * num_phases * (1 << PHASE_FRAC_BITS)))
    if step & ((1 << PHASE_FRAC_BITS) - 1):
        raise ValueError(f"{input_rate} -> {output_rate}: the walk is not "
                         "exact rational; the reference does not cover it")
    return TwoStage(2, design_upsample(2, quality), num_phases, bank, step)


def design(input_rate: float, output_rate: float, quality: str):
    """The stage filters of one configuration, as the program's plan
    chooses its topology: integer decimation, else the two-stage walk."""
    io = input_rate / output_rate
    if io >= 2.0 and abs(io - round(io)) < 1e-9:
        return design_decimation(int(round(io)), quality)
    return design_two_stage(input_rate, output_rate, quality)
