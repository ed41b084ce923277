"""Host-side exact output-length bookkeeping ("length model").

The engine runs with static shapes and emits a *constant-rate core*
stream that is then trimmed to the canonical output length — the number of
samples the reference engine produces for `Process(x); Flush()`
(SURVEY.md section 7, "Hard parts": data-dependent output lengths).

These simulators replicate the reference's per-stage counter arithmetic
with exact Python integers (no DSP), mirroring:

- DFT upsample counts:   dft_stage.go:156-207,341-349
- DFT decimation counts: dft_stage.go:488-553,576-584
- Polyphase walk counts: polyphase_stage.go:186-311,328-344
- Cascade flush order:   resampler.go:275-322

They are used at build time only.
"""

from __future__ import annotations

import dataclasses

from ..filterdesign.params import PHASE_FRAC_BITS

_FRAC = 1 << PHASE_FRAC_BITS


class DFTUpsampleSim:
    """Output counts of the reference DFT upsample stage (dft_stage.go:156)."""

    def __init__(self, factor: int, taps_per_phase: int):
        self.factor = factor
        self.taps = taps_per_phase
        self.hist = 0
        self.fed = False

    def process(self, n: int) -> int:
        if self.factor == 1:
            return n
        if n <= 0:
            return 0
        self.fed = True
        self.hist += n
        if self.hist < self.taps:
            return 0
        processable = self.hist - self.taps + 1
        self.hist -= processable
        return processable * self.factor

    def flush(self) -> int:
        # dft_stage.go:341-349: pad taps zeros, guarded when never fed
        if self.factor == 1 or self.hist == 0:
            return 0
        return self.process(self.taps)


class DecimationSim:
    """Output counts of the reference decimation stage (dft_stage.go:488)."""

    def __init__(self, factor: int, num_taps: int):
        self.factor = factor
        self.taps = num_taps
        self.hist = 0
        self.phase = 0

    def process(self, n: int) -> int:
        if self.factor == 1:
            return n
        if n <= 0:
            return 0
        self.hist += n
        if self.hist < self.taps:
            return 0
        filterable = self.hist - self.taps + 1
        # The reference's loop emits at phase, phase + M, ... < filterable;
        # counted in closed form (a per-output Python loop took ms per call).
        out = max(0, -(-(filterable - self.phase) // self.factor))
        # dft_stage.go:541: negative-modulo-safe phase carry
        self.phase = ((self.phase - filterable) % self.factor + self.factor) % self.factor
        self.hist -= filterable
        return out

    def flush(self) -> int:
        if self.factor == 1 or self.hist == 0:
            return 0
        return self.process(self.taps)


class PolyphaseSim:
    """Output counts of the reference polyphase walk (polyphase_stage.go:186)."""

    def __init__(self, num_phases: int, taps_per_phase: int, step: int):
        self.L = num_phases
        self.taps = taps_per_phase
        self.step = step
        self.at = 0
        self.hist = 0

    def process(self, n: int) -> int:
        if n <= 0:
            return 0
        self.hist += n
        num_in = self.hist - self.taps + 1
        if num_in <= 0:
            return 0
        limit = num_in * self.L * _FRAC
        if limit <= self.at:
            return 0
        num_out = (limit - self.at + self.step - 1) // self.step
        at_end = self.at + num_out * self.step
        consumed = (at_end >> PHASE_FRAC_BITS) // self.L
        consumed = min(consumed, self.hist)
        self.hist -= consumed
        self.at = at_end - consumed * self.L * _FRAC
        return num_out

    def flush(self) -> int:
        # polyphase_stage.go:328-344: pad taps zeros, guarded when never fed
        if self.hist == 0:
            return 0
        return self.process(self.taps)


class CubicSim:
    """Output counts of the cubic stage's 32-bit fixed-point walk.

    The reference cubic stage (cubic.go:33-63) uses a float64 phase
    accumulator; this framework uses an exact 32-bit fixed-point walk for
    reproducible counts (documented deviation; values are within the Quick
    preset's 8-bit accuracy).
    """

    FRAC_BITS = 32

    def __init__(self, ratio: float):
        self.step = max(1, int(round((1 << self.FRAC_BITS) / ratio)))
        self.emitted = 0
        self.fed = 0

    def process(self, n: int) -> int:
        if n <= 0:
            return 0
        self.fed += n
        # outputs k with (k*step) >> 32 < fed
        total = -(-(self.fed << self.FRAC_BITS) // self.step)  # ceil
        # k*step < fed*2^32  =>  count = ceil(fed*2^32 / step)
        out = total - self.emitted
        self.emitted = total
        return out

    def flush(self) -> int:
        return 0  # cubic.go:93-96: stateless flush


@dataclasses.dataclass
class LengthModel:
    """Canonical output-length model for a composed engine topology.

    ``canonical(n)`` is the total reference output count for
    ``Process(n samples); Flush()`` following resampler.go:275-322's flush
    orchestration.  ``core_emitted(n_fed)`` is the count the constant-rate
    core emits after being fed ``n_fed`` samples (real + zero padding),
    and ``flush_pad(n)`` the number of zero samples the core must be fed so
    it covers the canonical count.
    """

    kind: str                      # 'cubic' | 'dft_up' | 'decimate' | 'two_stage'
    factor: int = 1                # dft/decimation integer factor
    pre_taps: int = 0              # T1: prestage taps per phase
    taps: int = 0                  # T2 (polyphase) or T (decimation) taps
    num_phases: int = 1            # L
    step: int = 0                  # polyphase fixed-point step
    cubic_step: int = 0            # cubic 32-bit fixed-point step

    # -- canonical (reference) counts --------------------------------------

    def canonical(self, n: int) -> int:
        if n <= 0:
            return 0
        k = self.kind
        if k == 'cubic':
            sim = CubicSim.__new__(CubicSim)
            sim.step = self.cubic_step
            sim.emitted = 0
            sim.fed = 0
            return sim.process(n)
        if k == 'dft_up':
            pre = DFTUpsampleSim(self.factor, self.pre_taps)
            return pre.process(n) + pre.flush()
        if k == 'decimate':
            dec = DecimationSim(self.factor, self.taps)
            return dec.process(n) + dec.flush()
        if k == 'two_stage':
            pre = DFTUpsampleSim(self.factor, self.pre_taps)
            poly = PolyphaseSim(self.num_phases, self.taps, self.step)
            total = poly.process(pre.process(n))
            total += poly.process(pre.flush())   # resampler.go:285-300
            total += poly.flush()                # resampler.go:311-318
            return total
        raise ValueError(f"unknown topology kind: {k}")

    # -- constant-rate core counts -----------------------------------------

    def core_delta(self) -> int:
        """Zero-prefix of the core's post-prestage stream, in u-samples.

        For 'two_stage', the polyphase accumulator starts at
        ``core_delta() * L << 16`` so its output grid aligns exactly with
        the reference's (see engine/stages.py) and no outputs are dropped.
        """
        if self.kind in ('dft_up', 'two_stage'):
            return max(self.pre_taps - 1, 0) * self.factor
        return 0

    def drop_prefix(self) -> int:
        """Leading transient core *outputs* the wrapper must drop.

        Only the single-stage DFT upsample topology emits its zero-carry
        convolution ramp; all other topologies skip it structurally.
        """
        return self.core_delta() if self.kind == 'dft_up' else 0

    def core_emitted(self, n_fed: int) -> int:
        """Core output count after feeding n_fed input samples (incl. padding).

        For 'dft_up' this count *includes* the transient prefix of length
        ``core_delta()`` which the wrapper drops.
        """
        if n_fed <= 0:
            return 0
        k = self.kind
        if k == 'cubic':
            return -(-(n_fed << CubicSim.FRAC_BITS) // self.cubic_step)
        if k == 'dft_up':
            return n_fed * self.factor
        if k == 'decimate':
            # outputs at absolute filtered positions taps-1, taps-1+M, ... < n_fed
            first = self.taps - 1
            if n_fed <= first:
                return 0
            return -(-(n_fed - first) // self.factor)
        if k == 'two_stage':
            u_len = n_fed * self.factor
            num_in = u_len - self.taps + 1
            if num_in <= 0:
                return 0
            at0 = self.core_delta() * self.num_phases * _FRAC
            limit = num_in * self.num_phases * _FRAC
            if limit <= at0:
                return 0
            return (limit - at0 + self.step - 1) // self.step
        raise ValueError(f"unknown topology kind: {k}")

    def flush_pad(self, n: int) -> int:
        """Zero samples to feed the core so it reaches the canonical count."""
        if n <= 0:
            return 0
        target = self.canonical(n) + self.drop_prefix()
        z = 0
        # Start from a good guess, then walk up (each step is O(1)).
        if self.kind in ('dft_up', 'two_stage'):
            z = self.pre_taps + (0 if self.kind == 'dft_up'
                                 else -(-self.taps // self.factor))
        elif self.kind == 'decimate':
            z = self.taps
        while self.core_emitted(n + z) < target:
            z += 1
        return z
