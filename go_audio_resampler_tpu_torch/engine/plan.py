"""Engine planning: ratio topology selection and constant baking.

``plan_engine`` mirrors the reference's multi-stage architecture selection
(engine/resampler.go:51-179):

- QualityQuick            -> single cubic interpolation stage
- integer up-ratio        -> single DFT (polyphase FIR) upsample stage
- non-integer up-ratio    -> 2x DFT pre-stage + polyphase stage (hasPre=True)
- integer down-ratio >=2  -> DFT decimation stage
- non-integer down-ratio  -> 2x DFT pre-stage + polyphase stage (hasPre=False,
                             soxr's preM=0 case)

All filter coefficients are designed here in float64 numpy (build time) and
kept in the plan; the engine copies what it needs to the device.  A copy of
the JAX package's module, kept bit-equal to it, plus ``plan_from_arrays``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from ..filterdesign import params as fdp
from .counts import CubicSim, LengthModel

MIN_RATIO = 1.0 / 256.0   # resampler.go:62
MAX_RATIO = 256.0         # resampler.go:63
_FRAC = fdp.PHASE_FRAC_SCALE


class EngineConfigError(ValueError):
    """Invalid engine configuration (rates/ratio/quality)."""


def _is_integer_ratio(ratio: float) -> bool:
    """resampler.go:356-360: integer within 1e-9, and >= 1."""
    rounded = round(ratio)
    return abs(ratio - rounded) < 1e-9 and rounded >= 1.0


@dataclasses.dataclass(eq=False)
class EnginePlan:
    """Immutable build-time description of a resampler engine.

    Numeric arrays are float64 numpy; the engine casts them to its compute
    dtype when staging onto the device.  Identity-hashable (eq=False);
    build one plan per configuration and reuse it.
    """

    kind: str              # 'cubic' | 'dft_up' | 'decimate' | 'two_stage'
    input_rate: float
    output_rate: float
    ratio: float           # output/input
    quality: fdp.Quality

    # cubic stage
    cubic_step: int = 0    # 32-bit fixed-point step = round(2^32/ratio)

    # prestage (DFT upsample): factor F, taps-per-phase T1, bank [F, T1]
    factor: int = 1
    pre_coeffs: np.ndarray | None = None
    pre_taps: int = 0

    # decimation: factor M, reversed coeffs [T]
    decim_coeffs: np.ndarray | None = None
    decim_taps: int = 0

    # polyphase: L phases, T2 taps/phase, cubic banks [L, T2] each
    num_phases: int = 0
    poly_taps: int = 0
    step: int = 0          # fixed-point (16 frac bits)
    bank_a: np.ndarray | None = None
    bank_b: np.ndarray | None = None
    bank_c: np.ndarray | None = None
    bank_d: np.ndarray | None = None

    # strict-antialias 1:1 prefilter (beyond reference; see
    # filterdesign.params.AntialiasPrefilter).  Natural-order symmetric
    # coeffs; applied delay-compensated so counts/latency are unchanged.
    aa_coeffs: np.ndarray | None = None
    aa_taps: int = 0

    lengths: LengthModel | None = None

    # ---- derived helpers -------------------------------------------------

    @property
    def fingerprint(self) -> tuple:
        """Stable identity for host-side matrix caches.

        Keying caches on this tuple instead of ``id(plan)`` avoids stale
        hits when a GC'd plan's id is reused (plan_engine's lru_cache can
        evict plans while derived matrices outlive them).  A digest of the
        coefficient arrays is included so hand-perturbed plan copies (the
        mutation-detection test tier builds these) never alias the
        pristine plan's matrices.
        """
        fp = getattr(self, '_fingerprint', None)
        if fp is None:
            import hashlib
            h = hashlib.blake2b(digest_size=16)
            for arr in (self.pre_coeffs, self.decim_coeffs, self.bank_a,
                        self.bank_b, self.bank_c, self.bank_d,
                        self.aa_coeffs):
                h.update(b'|' if arr is None else
                         np.ascontiguousarray(arr).tobytes())
            fp = (self.kind, float(self.input_rate),
                  float(self.output_rate), int(self.quality),
                  int(self.aa_taps), self.step, self.cubic_step,
                  h.hexdigest())
            self._fingerprint = fp
        return fp

    @property
    def at0(self) -> int:
        """Initial polyphase accumulator: core_delta * L << 16.

        Aligns the core's output grid with the reference's despite the
        zero-carry prestage prefix (see the JAX package's engine/stages.py).
        """
        if self.kind != 'two_stage':
            return 0
        return self.lengths.core_delta() * self.num_phases * _FRAC

    @property
    def step_hi(self) -> int:
        return self.step >> fdp.PHASE_FRAC_BITS

    @property
    def step_lo(self) -> int:
        return self.step & fdp.PHASE_FRAC_MASK

    @property
    def is_rational_exact(self) -> bool:
        """True when the polyphase walk never uses fractional sub-phases.

        Then the stage is exactly periodic and lowers to a frames-matmul
        (the fused banded step); true for all exact rational audio ratios,
        e.g. CD<->DAT.
        """
        return self.kind == 'two_stage' and self.step_lo == 0

    def estimate_output(self, n_in: int) -> int:
        """Upper bound on output samples: floor(n*ratio) + 64.

        Reference parity: constant.go:117-119 / convenience.go:164-166
        (the reference also floors; the +64 slack covers the rounding).
        """
        return int(n_in * self.ratio) + 64

    def latency(self) -> int:
        """Filter latency in input samples: sum(taps*factor)/2 per stage.

        Reference parity: stage_adapter.go:43-58.
        """
        total = 0
        if self.kind == 'cubic':
            return 2
        if self.kind in ('dft_up', 'two_stage') and self.pre_taps:
            total += self.pre_taps * self.factor
        if self.kind == 'decimate':
            total += self.decim_taps
        if self.kind == 'two_stage':
            total += self.poly_taps * 2
        return total // 2

    def filter_length(self) -> int:
        if self.kind == 'cubic':
            return 4
        if self.kind == 'dft_up':
            return self.pre_taps * self.factor
        if self.kind == 'decimate':
            return self.decim_taps
        return (self.pre_taps * self.factor
                + self.poly_taps * self.num_phases + self.aa_taps)

    def algorithm(self) -> str:
        return {
            'cubic': 'cubic',
            'dft_up': 'dft-polyphase-upsample',
            'decimate': 'dft-decimation',
            'two_stage': 'dft+polyphase',
        }[self.kind]


#: Phase-bank densification factor for the opt-in HQ inter-phase mode:
#: cubic interpolation error scales ~(1/L)^4, so 8x denser banks buy
#: ~+72 dB of inter-phase accuracy at zero runtime cost (same
#: taps-per-phase, same gather+Horner+dot device shape; only bank bytes
#: and host design time grow).  Beyond-reference: the reference caps L
#: at 256 via libsoxr's 8191-tap design-library limit
#: (filter_params.go:575-627).
HQ_PHASE_MULT = 8


@functools.lru_cache(maxsize=256)
def plan_engine(input_rate: float, output_rate: float,
                quality: fdp.Quality,
                strict_antialias: bool = False,
                hq_interp: bool = False) -> EnginePlan:
    """Select topology and design all stage filters (resampler.go:51-179).

    Memoized: repeated construction with the same configuration returns the
    identical plan object.
    Treat the returned plan (including its arrays) as immutable.

    ``hq_interp`` (beyond reference, opt-in): densify the polyphase
    inter-phase banks by HQ_PHASE_MULT for non-exact-rational ratios,
    pushing the general walk's interpolation floor from ~-89 dB THD to
    the filter's own floor.  No-op for exact-rational ratios (their walk
    never interpolates; the fused matrix path is already exact) and for
    the cubic/dft_up/decimate topologies (no inter-phase banks).
    """
    if not (math.isfinite(input_rate) and math.isfinite(output_rate)):
        raise EngineConfigError(
            f"sample rates must be finite: input={input_rate}, output={output_rate}")
    if input_rate <= 0 or output_rate <= 0:
        raise EngineConfigError(
            f"sample rates must be positive: input={input_rate}, output={output_rate}")
    ratio = output_rate / input_rate
    if ratio < MIN_RATIO or ratio > MAX_RATIO:
        raise EngineConfigError(
            f"resampling ratio {ratio:.6f} out of valid range "
            f"[{MIN_RATIO:.6f}, {MAX_RATIO:.0f}]")
    quality = fdp.Quality(quality)

    if quality is fdp.Quality.QUICK:
        step = max(1, int(round((1 << CubicSim.FRAC_BITS) / ratio)))
        plan = EnginePlan(kind='cubic', input_rate=input_rate,
                          output_rate=output_rate, ratio=ratio,
                          quality=quality, cubic_step=step)
        plan.lengths = LengthModel(kind='cubic', cubic_step=step)
        return plan

    if ratio >= 1.0:
        if _is_integer_ratio(ratio):
            factor = int(round(ratio))
            pre = fdp.design_dft_upsample(factor, quality)
            plan = EnginePlan(kind='dft_up', input_rate=input_rate,
                              output_rate=output_rate, ratio=ratio,
                              quality=quality, factor=factor,
                              pre_coeffs=pre.phase_coeffs,
                              pre_taps=pre.taps_per_phase)
            plan.lengths = LengthModel(kind='dft_up', factor=factor,
                                       pre_taps=pre.taps_per_phase)
            return plan
        # Non-integer upsampling: 2x DFT pre-stage + polyphase
        pre_factor = 2
        pre = fdp.design_dft_upsample(pre_factor, quality)
        poly_ratio = output_rate / (input_rate * pre_factor)
        total_io = input_rate / output_rate
        has_pre = True   # resampler.go:116
    else:
        io_ratio = input_rate / output_rate
        if _is_integer_ratio(io_ratio) and io_ratio >= 2.0:
            factor = int(round(io_ratio))
            dec = fdp.design_decimation(factor, quality)
            plan = EnginePlan(kind='decimate', input_rate=input_rate,
                              output_rate=output_rate, ratio=ratio,
                              quality=quality, factor=factor,
                              decim_coeffs=dec.coeffs, decim_taps=dec.num_taps)
            plan.lengths = LengthModel(kind='decimate', factor=factor,
                                       taps=dec.num_taps)
            return plan
        # Non-integer downsampling: 2x upsample pre-stage + polyphase
        pre_factor = 2
        pre = fdp.design_dft_upsample(pre_factor, quality)
        poly_ratio = output_rate / (input_rate * pre_factor)
        total_io = io_ratio
        has_pre = False  # resampler.go:166-169: preM=0 in soxr terms

    num_phases, _ = fdp.find_rational_approx(poly_ratio)
    hq_phases = 0
    if hq_interp:
        step_probe = fdp.polyphase_step(poly_ratio, num_phases)
        if step_probe & fdp.PHASE_FRAC_MASK:   # walk actually interpolates
            hq_phases = num_phases * HQ_PHASE_MULT
    bank = fdp.design_polyphase_filter(num_phases, poly_ratio, total_io,
                                       has_pre, quality,
                                       hq_phases=hq_phases)
    num_phases = bank.num_phases
    A, B, C, D = fdp.cubic_phase_banks(bank, correct_wrap=hq_interp)
    step = fdp.polyphase_step(poly_ratio, num_phases)

    aa_coeffs, aa_taps = None, 0
    if strict_antialias and ratio < 1.0:
        aa = fdp.design_antialias_prefilter(ratio, quality)
        aa_coeffs, aa_taps = aa.coeffs, aa.num_taps

    plan = EnginePlan(kind='two_stage', input_rate=input_rate,
                      output_rate=output_rate, ratio=ratio, quality=quality,
                      factor=pre_factor, pre_coeffs=pre.phase_coeffs,
                      pre_taps=pre.taps_per_phase, num_phases=num_phases,
                      poly_taps=bank.taps_per_phase, step=step,
                      bank_a=A, bank_b=B, bank_c=C, bank_d=D,
                      aa_coeffs=aa_coeffs, aa_taps=aa_taps)
    plan.lengths = LengthModel(kind='two_stage', factor=pre_factor,
                               pre_taps=pre.taps_per_phase,
                               taps=bank.taps_per_phase,
                               num_phases=num_phases, step=step)
    return plan


def plan_from_arrays(fields: dict) -> EnginePlan:
    """Build a plan from another plan's fields (``dataclasses.fields`` names).

    ``fields`` maps every :class:`EnginePlan` field name to its value, as
    read off a plan of the JAX package; its arrays are copied as float64
    numpy, its ``quality`` and ``lengths`` are rebuilt as this package's
    types.  Lets two engines run the very same filter bank even if the
    two designs ever drift apart.
    """
    kw = {}
    for f in dataclasses.fields(EnginePlan):
        v = fields[f.name]
        if f.name == 'quality':
            v = fdp.Quality(int(v))
        elif f.name == 'lengths' and v is not None:
            v = LengthModel(**{g.name: getattr(v, g.name)
                               for g in dataclasses.fields(LengthModel)})
        elif isinstance(v, np.ndarray):
            v = np.array(v, dtype=np.float64)
        kw[f.name] = v
    return EnginePlan(**kw)
