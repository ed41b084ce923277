"""soxr-style filter-parameter math and polyphase bank design (host-side).

This is the framework's port of the *math* of the reference's
``internal/engine/filter_params.go`` — the critical Fn/Fp/Fs normalization,
the lsx_inv_f_resp rolloff compensation, the rational approximation used to
pick the phase count, and the polyphase prototype design + cubic
sub-phase coefficient banks.  Constants are verbatim; the implementation is
numpy and runs only at build time.

Reference parity map (file:line refer to the Go reference repository):

- ``Quality`` enum            <-> engine.Quality         (filter_params.go:16-41)
- ``quality_to_attenuation``  <-> qualityToAttenuation   (filter_params.go:150-175)
- ``quality_to_passband_end`` <-> qualityToPassbandEnd   (filter_params.go:180-195)
- ``lsx_inv_f_resp``          <-> lsxInvFResp            (filter_params.go:355-394)
- ``compute_polyphase_filter_params`` <-> ComputePolyphaseFilterParams
                                           (filter_params.go:446-630)
- ``find_rational_approx``    <-> findRationalApprox     (filter_params.go:294-329)
- ``design_polyphase_filter`` <-> designPolyphaseFilter  (filter_params.go:229-286)
- ``cubic_phase_banks``       <-> NewPolyphaseStage coefficient setup
                                           (polyphase_stage.go:105-154)
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from . import kaiser

# --- Quality model (filter_params.go:16-68) --------------------------------

DB_PER_BIT = 6.0206  # 20*log10(2)


class Quality(enum.IntEnum):
    """Engine quality levels, matching soxr's presets.

    Reference parity: engine.Quality (filter_params.go:16-41).
    """

    QUICK = 0
    LOW = 1
    MEDIUM = 2
    HIGH = 3
    VERY_HIGH = 4
    BITS_16 = 5
    BITS_20 = 6
    BITS_24 = 7
    BITS_28 = 8
    BITS_32 = 9


_QUALITY_BITS = {
    Quality.QUICK: 8,
    Quality.LOW: 16,
    Quality.MEDIUM: 16,
    Quality.HIGH: 20,
    Quality.VERY_HIGH: 28,
    Quality.BITS_16: 16,
    Quality.BITS_20: 20,
    Quality.BITS_24: 24,
    Quality.BITS_28: 28,
    Quality.BITS_32: 32,
}

# Passband end (Fp0) fractions of Nyquist (filter_params.go:72-75)
PASSBAND_LOW = 0.67625       # soxr lq_bw0 = 1385/2048
PASSBAND_MEDIUM = 0.91
PASSBAND_HIGH = 0.912
PASSBAND_VERY_HIGH = 0.913

# DFT / decimation stage constants (filter_params.go:113-124)
SOXR_DFT_STAGE_FC = 0.4778321
TRANSITION_BW_FACTOR = 0.05
NYQUIST_FRACTION = 0.5
IMAGE_REJECTION_FACTOR = 2.0
SOXR_DOWNSAMPLING_FN_FACTOR = 2.0
SOXR_DOWNSAMPLING_FS_BASE = 3.0
SOXR_UPSAMPLING_FS_COEFF = 0.7

# lsx_inv_f_resp constants (filter_params.go:126-138)
_SINE_PHI_A3 = 2.0517e-07
_SINE_PHI_A2 = -1.1303e-04
_SINE_PHI_A1 = 0.023154
_SINE_PHI_A0 = 0.55924
_MIN_ATT = 1.0
_MAX_ATT = 300.0
_SINE_EPS = 1e-10
_INV_F_RESP_THRESHOLD = 0.999

# Cubic sub-phase interpolation constants (filter_params.go:140-147)
_CUBIC_PHASE_OFFSET = 2
_CUBIC_CENTER_COEFF = 0.5
_CUBIC_DIVISOR = 6.0
_CUBIC_C_MULT = 4.0

# Fixed-point sub-phase precision (polyphase_stage.go:93-94)
PHASE_FRAC_BITS = 16
PHASE_FRAC_SCALE = 1 << PHASE_FRAC_BITS
PHASE_FRAC_MASK = PHASE_FRAC_SCALE - 1

HISTORY_BUFFER_MULTIPLIER = 2
L2_CACHE_CHUNK_SIZE = 4096
RATIONAL_APPROX_TOLERANCE = 1e-10


def quality_to_attenuation(q: Quality) -> float:
    """Stopband attenuation in dB: (bits + 1) * 6.0206.

    Reference parity: filter_params.go:150-175.
    """
    bits = _QUALITY_BITS.get(Quality(q), 20)
    return (bits + 1) * DB_PER_BIT


def quality_to_passband_end(q: Quality) -> float:
    """Passband end (Fp0) as a fraction of Nyquist.

    Reference parity: filter_params.go:180-195.
    """
    q = Quality(q)
    if q in (Quality.QUICK, Quality.LOW, Quality.BITS_16):
        return PASSBAND_LOW
    if q is Quality.MEDIUM:
        return PASSBAND_MEDIUM
    if q in (Quality.HIGH, Quality.BITS_20):
        return PASSBAND_HIGH
    if q in (Quality.VERY_HIGH, Quality.BITS_24, Quality.BITS_28, Quality.BITS_32):
        return PASSBAND_VERY_HIGH
    return PASSBAND_HIGH


# --- lsx_inv_f_resp (filter_params.go:355-394) -----------------------------

def lsx_inv_f_resp(drop: float, attenuation: float) -> float:
    """Normalized frequency where the response has dropped by ``drop`` dB.

    Port of soxr filter.c's lsx_inv_f_resp with the reference's NaN guards.
    Reference parity: filter_params.go:355-394.
    """
    a = min(max(attenuation, _MIN_ATT), _MAX_ATT)
    x = ((_SINE_PHI_A3 * a + _SINE_PHI_A2) * a + _SINE_PHI_A1) * a + _SINE_PHI_A0
    drop_linear = math.exp(drop * math.log(10.0) * 0.05)
    s = 1.0 - drop_linear if drop_linear > 0.5 else drop_linear
    sin_val = math.sin(x * 0.5)
    if sin_val <= _SINE_EPS:
        sin_val = _SINE_EPS
    sine_pow = math.log(0.5) / math.log(sin_val)
    x = math.asin(s ** (1.0 / sine_pow)) / x
    return x if drop_linear > 0.5 else 1.0 - x


# --- Parameter computation (filter_params.go:446-630) ----------------------

@dataclasses.dataclass
class PolyphaseFilterParams:
    """Computed polyphase design parameters.

    Mirrors the reference's exported PolyphaseFilterParams struct
    (filter_params.go:402-428) so tests can assert at the parameter level.
    """

    num_phases: int
    ratio: float
    total_io_ratio: float
    has_pre_stage: bool
    attenuation: float

    is_upsampling: bool = False
    mult: float = 1.0
    fn: float = 1.0
    fp1: float = 0.0
    fs1: float = 0.0
    fp_raw: float = 0.0
    fs_raw: float = 0.0
    fp: float = 0.0
    fs: float = 0.0
    tr_bw: float = 0.0
    fc: float = 0.0
    total_taps: int = 0
    taps_per_phase: int = 0


def compute_polyphase_filter_params(
    num_phases: int,
    ratio: float,
    total_io_ratio: float,
    has_pre_stage: bool,
    attenuation: float,
    passband_end: float,
) -> PolyphaseFilterParams:
    """soxr's Fn/Fp/Fs normalization and tap sizing.

    The critical branch (soxr cr.c:429-431):
      - downsampling WITH a decimating pre-stage: Fn = 2*mult, Fs = 3+|Fs1-1|
      - upsampling OR no (decimating) pre-stage:  Fn = 1,
        Fs = 2 - (Fp1 + (Fs1-Fp1)*0.7)

    Reference parity: ComputePolyphaseFilterParams (filter_params.go:446-630),
    constants verbatim.
    """
    p = PolyphaseFilterParams(
        num_phases=num_phases, ratio=ratio, total_io_ratio=total_io_ratio,
        has_pre_stage=has_pre_stage, attenuation=attenuation)

    phases = float(num_phases)
    p.is_upsampling = total_io_ratio < 1.0
    p.mult = 1.0 if p.is_upsampling else total_io_ratio

    if p.is_upsampling:
        p.fp1 = total_io_ratio * passband_end
        p.fs1 = total_io_ratio * 1.0
    else:
        p.fp1 = passband_end * ratio
        p.fs1 = ratio

    if (not p.is_upsampling) and has_pre_stage:
        p.fn = SOXR_DOWNSAMPLING_FN_FACTOR * p.mult
        p.fs_raw = SOXR_DOWNSAMPLING_FS_BASE + abs(p.fs1 - 1.0)
        p.fp_raw = p.fp1
    else:
        p.fn = 1.0
        p.fs_raw = IMAGE_REJECTION_FACTOR - (
            p.fp1 + (p.fs1 - p.fp1) * SOXR_UPSAMPLING_FS_COEFF)
        p.fp_raw = p.fp1

    inv_f_resp = lsx_inv_f_resp(-0.01, attenuation)
    if inv_f_resp < _INV_F_RESP_THRESHOLD:
        adjusted_fp = p.fs_raw - (p.fs_raw - p.fp_raw) / (1.0 - inv_f_resp)
        if 0.0 < adjusted_fp < p.fs_raw:
            p.fp_raw = adjusted_fp

    p.fp = p.fp_raw / abs(p.fn)
    p.fs = p.fs_raw / abs(p.fn)

    p.tr_bw = 0.5 * (p.fs - p.fp) / phases
    tr_bw_limit = 0.5 * p.fs / phases
    if p.tr_bw > tr_bw_limit:
        p.tr_bw = tr_bw_limit
    min_tr_bw = 0.001
    if p.tr_bw < min_tr_bw:
        p.tr_bw = min_tr_bw

    p.fc = p.fs / phases - p.tr_bw
    if p.fc < min_tr_bw:
        p.fc = min_tr_bw

    # Tap sizing with per-quality caps (filter_params.go:575-627)
    min_taps_per_phase = 8
    filter_lib_limit = 8191 - 1
    low_q_att, high_q_att, vhq_att = 110.0, 130.0, 160.0
    if attenuation < low_q_att:
        max_taps_per_phase = 32
    elif attenuation < high_q_att:
        max_taps_per_phase = 64
    elif attenuation < vhq_att:
        max_taps_per_phase = 100
    else:
        max_taps_per_phase = (filter_lib_limit + 1) // num_phases

    ideal_taps = int(math.ceil(attenuation / p.tr_bw + 1))
    p.total_taps = ideal_taps
    p.taps_per_phase = (p.total_taps + num_phases - 1) // num_phases
    p.taps_per_phase = min(max(p.taps_per_phase, min_taps_per_phase),
                           max_taps_per_phase)
    p.total_taps = num_phases * p.taps_per_phase - 1
    if p.total_taps > filter_lib_limit:
        p.taps_per_phase = max((filter_lib_limit + 1) // num_phases,
                               min_taps_per_phase)
        p.total_taps = num_phases * p.taps_per_phase - 1
    return p


def find_rational_approx(ratio: float) -> tuple[int, int]:
    """Pick (num_phases L, step) with step/L ~ 1/ratio; L in [64, 256].

    Defaults to soxr's 80 phases for CD<->DAT-like ratios.
    Reference parity: findRationalApprox (filter_params.go:294-329).
    """
    default_phases = 80
    max_phases = 256
    inv_ratio = 1.0 / ratio
    best_l = default_phases
    best_step = int(round(inv_ratio * default_phases))
    best_err = abs(best_step / best_l - inv_ratio)
    for l in range(64, max_phases + 1):
        candidate = int(round(inv_ratio * l))
        if candidate <= 0:
            continue
        err = abs(candidate / l - inv_ratio)
        if err < best_err:
            best_l, best_step, best_err = l, candidate, err
        if best_err < RATIONAL_APPROX_TOLERANCE:
            break
    return best_l, best_step


@dataclasses.dataclass
class PolyphaseFilter:
    """Polyphase bank with flat layout coeffs[tap * num_phases + phase].

    Mirrors the reference's polyphaseFilter (filter_params.go:202-206).
    """

    coeffs: np.ndarray  # flat [taps_per_phase * num_phases]
    num_phases: int
    taps_per_phase: int


def design_polyphase_filter(
    num_phases: int,
    ratio: float,
    total_io_ratio: float,
    has_pre_stage: bool,
    quality: Quality,
    hq_phases: int = 0,
) -> PolyphaseFilter:
    """Design the polyphase prototype and decompose into phases.

    Prototype DC gain is normalized to ``num_phases`` so each phase has DC
    gain ~1.0.  Reference parity: designPolyphaseFilter
    (filter_params.go:229-286).

    ``hq_phases`` (> num_phases) samples the SAME continuous prototype at
    a denser phase grid: cutoff and transition band scale by
    num_phases/hq_phases while taps-per-phase stays fixed, so the filter's
    frequency response is unchanged but the cubic inter-phase
    interpolation error drops ~(num_phases/hq_phases)^4 (the beyond-
    reference opt-in mode; the reference caps L at 256 via libsoxr's
    8191-tap design limit, filter_params.go:575-627 — a design-time-only
    constraint that does not bind here).  Runtime per-output work is
    unchanged (same taps_per_phase, same gather+Horner+dot shape); only
    bank memory and host design time grow.
    """
    attenuation = quality_to_attenuation(quality)
    passband_end = quality_to_passband_end(quality)
    params = compute_polyphase_filter_params(
        num_phases, ratio, total_io_ratio, has_pre_stage, attenuation,
        passband_end)

    cutoff = params.fc / 2.0  # soxr [0,1] scale -> our [0,0.5]
    cutoff = min(max(cutoff, 0.001), 0.499)

    design_phases = num_phases
    total_taps = params.total_taps
    if hq_phases > num_phases:
        # Same continuous filter, denser phase sampling: the per-phase
        # geometry (taps_per_phase, per-output runtime cost) is invariant.
        scale = num_phases / hq_phases
        cutoff = max(cutoff * scale, 1e-6)
        design_phases = hq_phases
        total_taps = hq_phases * params.taps_per_phase - 1

    prototype = kaiser.design_lowpass(
        kaiser.FilterParams(num_taps=total_taps, cutoff_freq=cutoff,
                            attenuation=attenuation, gain=1.0),
        max_taps=max(kaiser.MAX_FILTER_TAPS, total_taps))

    total = float(prototype.sum())
    if total != 0.0:
        prototype = prototype * (design_phases / total)

    coeffs = np.zeros(params.taps_per_phase * design_phases,
                      dtype=np.float64)
    n = len(prototype)
    # coeffs[tap * L + phase] = prototype[tap * L + phase]  (zero-padded)
    coeffs[:min(len(coeffs), n)] = prototype[:min(len(coeffs), n)]
    return PolyphaseFilter(coeffs=coeffs, num_phases=design_phases,
                           taps_per_phase=params.taps_per_phase)


def polyphase_step(ratio: float, num_phases: int) -> int:
    """Fixed-point step per output sample: round((1/ratio)*L*2^16).

    Reference parity: polyphase_stage.go:96-102 — the full-precision step is
    recomputed here rather than reusing find_rational_approx's integer step,
    so sub-phase interpolation keeps its fractional bits.
    """
    return int(round((1.0 / ratio) * num_phases * PHASE_FRAC_SCALE))


def cubic_phase_banks(bank: PolyphaseFilter, correct_wrap: bool = False
                      ) -> tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Catmull-Rom-style cubic sub-phase coefficient banks A/B/C/D.

    coef(x) = a + x*(b + x*(c + x*d)), x in [0,1); phases wrap around for
    interpolation at bank boundaries; taps stored REVERSED so a forward dot
    with history windows reproduces the convolution direction.
    Returns arrays of shape [num_phases, taps_per_phase].
    Reference parity: NewPolyphaseStage (polyphase_stage.go:105-154).

    ``correct_wrap`` (beyond reference, used by the HQ interp mode):
    in the flat layout coeffs[tap*L + phase], the sample that follows
    phase L-1 of tap t is phase 0 of tap t+1 (the prototype's next flat
    sample, one whole sample later in the underlying continuous kernel)
    — NOT phase 0 of the same tap, which sits L flat positions earlier.
    The reference's getCoeff wraps phase modulo L without the tap shift
    (polyphase_stage.go:105-117), so the three boundary phases
    {0, L-2, L-1} interpolate toward coefficients from the wrong kernel
    position (measured coefficient error up to -2 dB relative to the
    prototype peak, vs ~-100 dB at interior phases) — this is the
    ~-88 dB THD floor of the general non-exact path.  With the tap
    shift, boundary phases interpolate the true neighboring samples and
    the floor drops to the filter's own response.
    """
    L = bank.num_phases
    T = bank.taps_per_phase
    flat = bank.coeffs

    def get(phase: int, tap: int) -> float:
        q, wrapped = divmod(phase, L)
        if correct_wrap:
            tap = tap + q       # crossing the bank boundary advances the tap
        idx = tap * L + wrapped
        if idx < 0 or idx >= len(flat) or tap < 0 or tap >= T:
            return 0.0
        return float(flat[idx])

    A = np.zeros((L, T), dtype=np.float64)
    B = np.zeros((L, T), dtype=np.float64)
    C = np.zeros((L, T), dtype=np.float64)
    D = np.zeros((L, T), dtype=np.float64)
    for phase in range(L):
        for tap in range(T):
            f0 = get(phase, tap)
            f1 = get(phase + 1, tap)
            fm1 = get(phase - 1, tap)
            f2 = get(phase + _CUBIC_PHASE_OFFSET, tap)
            a = f0
            c = _CUBIC_CENTER_COEFF * (f1 + fm1) - f0
            d = (1.0 / _CUBIC_DIVISOR) * (f2 - f1 + fm1 - f0 - _CUBIC_C_MULT * c)
            b = f1 - f0 - d - c
            rev = T - 1 - tap
            A[phase, rev] = a
            B[phase, rev] = b
            C[phase, rev] = c
            D[phase, rev] = d
    return A, B, C, D


# --- DFT (integer-factor) stage filter design ------------------------------

@dataclasses.dataclass
class DFTUpsampleFilter:
    """Polyphase bank for integer-factor upsampling.

    ``phase_coeffs[phase, tap]`` are scaled by ``factor`` and tap-REVERSED,
    ready for a forward dot with history windows.  Half-band detection marks
    a passthrough phase 0 (single tap ~1.0) for the 2x case.
    Reference parity: NewDFTStage (dft_stage.go:50-146).
    """

    factor: int
    phase_coeffs: np.ndarray  # [factor, taps_per_phase]
    taps_per_phase: int
    is_half_band: bool
    phase0_tap_offset: int
    phase0_tap_scale: float


def design_dft_upsample(factor: int, quality: Quality) -> DFTUpsampleFilter:
    """Anti-imaging lowpass for L-x upsampling, decomposed per phase.

    Cutoff = soxr's Fc 0.4778321 / factor; transition bw = 0.05 / factor.
    Reference parity: NewDFTStage (dft_stage.go:50-146).
    """
    if factor < 1:
        raise kaiser.FilterDesignError(f"upsampling factor must be >= 1: {factor}")
    if factor == 1:
        return DFTUpsampleFilter(1, np.zeros((1, 0)), 0, False, 0, 1.0)

    cutoff = SOXR_DFT_STAGE_FC / factor
    transition_bw = TRANSITION_BW_FACTOR / factor
    attenuation = quality_to_attenuation(quality)
    proto = kaiser.design_lowpass_auto(cutoff, transition_bw, attenuation, 1.0)

    taps_per_phase = (len(proto) + factor - 1) // factor
    coeffs = np.zeros((factor, taps_per_phase), dtype=np.float64)
    for phase in range(factor):
        for tap in range(taps_per_phase):
            idx = tap * factor + phase
            if idx < len(proto):
                coeffs[phase, taps_per_phase - 1 - tap] = proto[idx] * factor

    is_half_band = False
    phase0_off = 0
    phase0_scale = 1.0
    if factor == 2:
        threshold = 1e-8
        sig = np.nonzero(np.abs(coeffs[0]) > threshold)[0]
        if len(sig) == 1 and abs(coeffs[0, sig[0]] - 1.0) < 0.01:
            is_half_band = True
            phase0_off = int(sig[0])
            phase0_scale = float(coeffs[0, sig[0]])

    return DFTUpsampleFilter(
        factor=factor, phase_coeffs=coeffs, taps_per_phase=taps_per_phase,
        is_half_band=is_half_band, phase0_tap_offset=phase0_off,
        phase0_tap_scale=phase0_scale)


@dataclasses.dataclass
class DecimationFilter:
    """Full-rate FIR for integer-factor decimation, tap-REVERSED.

    Reference parity: NewDFTDecimationStage (dft_stage.go:401-475).
    """

    factor: int
    coeffs: np.ndarray  # [num_taps], reversed
    num_taps: int


# Beyond-reference: minimum design attenuation for the decimation prototype
# at HIGH quality and above.  The reference uses quality_to_attenuation
# directly (126.4 dB at HIGH), which measures ~148 dB steady-state alias
# rejection — short of the libsoxr capture's 157.14 dB (96k->48k,
# soxr_reference_data.json).  Flooring the design attenuation at 150 dB
# raises HIGH's steady-state rejection past the capture; passband behavior
# (THD/DC/ripple) is unchanged because Fp/Fc stay the same and Kaiser
# passband ripple tracks the (deeper) stopband ripple.
DECIM_ATTENUATION_FLOOR_DB = 150.0
_DECIM_FLOOR_MIN_QUALITY_ATT = 120.0   # applies to HIGH/BITS_20 and up


def design_decimation(factor: int, quality: Quality) -> DecimationFilter:
    """Anti-aliasing lowpass for M-x decimation (cutoff near output Nyquist).

    Fp = passband_end(q)/factor, Fs = 1/factor, trBW = 0.5*(Fs-Fp),
    Fc = Fs - trBW, all scaled to the [0, 0.5] design convention.
    Reference parity: NewDFTDecimationStage (dft_stage.go:401-475), plus the
    beyond-reference HIGH+ attenuation floor (DECIM_ATTENUATION_FLOOR_DB).
    """
    if factor < 1:
        raise kaiser.FilterDesignError(f"decimation factor must be >= 1: {factor}")
    if factor == 1:
        return DecimationFilter(1, np.zeros(0), 0)
    fp_norm = quality_to_passband_end(quality) / factor
    fs_norm = 1.0 / factor
    tr_bw = 0.5 * (fs_norm - fp_norm)
    fc = fs_norm - tr_bw
    cutoff = fc * NYQUIST_FRACTION
    attenuation = quality_to_attenuation(quality)
    if attenuation >= _DECIM_FLOOR_MIN_QUALITY_ATT:
        attenuation = max(attenuation, DECIM_ATTENUATION_FLOOR_DB)
    transition_bw = tr_bw * NYQUIST_FRACTION
    proto = kaiser.design_lowpass_auto(cutoff, transition_bw, attenuation, 1.0)
    return DecimationFilter(factor=factor, coeffs=proto[::-1].copy(),
                            num_taps=len(proto))


@dataclasses.dataclass
class AntialiasPrefilter:
    """1:1 anti-alias prefilter for strict non-integer downsampling.

    Beyond-reference: the reference's non-integer downsampling chain (2x
    upsampling pre-stage + polyphase, soxr's preM=0 case) leaves the
    would-alias band [outNyq, inNyq] essentially unattenuated — a behavior
    its tests treat as informational (antialiasing_test.go:727-737), while
    real libsoxr rejects it by 171+ dB (soxr_reference_data.json).  Strict
    mode closes that gap with a linear-phase full-input-rate lowpass
    (passband to passband_end(q)*outNyq, stopband at outNyq) applied as a
    delay-compensated 'same' convolution before the unchanged default
    chain, so output sample counts/grid and passband behavior are
    identical to the default path.

    ``coeffs`` are in natural order (symmetric — linear phase); ``num_taps``
    is odd so the (T-1)/2 group delay compensates exactly.
    """

    coeffs: np.ndarray
    num_taps: int

    @property
    def delay(self) -> int:
        return (self.num_taps - 1) // 2


def design_antialias_prefilter(ratio: float,
                               quality: Quality) -> AntialiasPrefilter:
    """Lowpass with Fp = passband_end(q)*ratio, Fs = ratio (Nyquist-rel.).

    Same attenuation rule as the decimation stage, including the HIGH+
    150 dB floor (DECIM_ATTENUATION_FLOOR_DB).
    """
    if not (0.0 < ratio < 1.0):
        raise kaiser.FilterDesignError(
            f"prefilter requires a downsampling ratio in (0,1): {ratio}")
    fp_norm = quality_to_passband_end(quality) * ratio
    fs_norm = ratio
    tr_bw = 0.5 * (fs_norm - fp_norm)
    fc = fs_norm - tr_bw
    cutoff = min(max(fc * NYQUIST_FRACTION, 0.001), 0.499)
    attenuation = quality_to_attenuation(quality)
    if attenuation >= _DECIM_FLOOR_MIN_QUALITY_ATT:
        attenuation = max(attenuation, DECIM_ATTENUATION_FLOOR_DB)
    transition_bw = tr_bw * NYQUIST_FRACTION
    proto = kaiser.design_lowpass_auto(cutoff, transition_bw, attenuation, 1.0)
    assert len(proto) % 2 == 1, "Kaiser auto design must return odd taps"
    return AntialiasPrefilter(coeffs=proto, num_taps=len(proto))
