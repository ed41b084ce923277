"""analyze-filter: polyphase filter bank DC-gain diagnostic.

Counterpart of the JAX package's ``cli/analyze_filter.py``
(cmd/analyze-filter, analyze_filter_gain.go:28-132): designs a
standalone polyphase bank and prints per-phase DC gain statistics, a
filter-design debugging aid that confirms each phase has unity gain after
prototype normalization.  The design is host numpy; no device is used.

Usage:
    python -m go_audio_resampler_tpu_torch.cli.analyze_filter \
        -phases 80 -taps 32 -cutoff 0.45 -attenuation 120
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def run(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="analyze-filter",
        description="Print per-phase DC gain of a designed polyphase bank")
    p.add_argument("-phases", type=int, default=80)
    p.add_argument("-taps", type=int, default=32, help="taps per phase")
    p.add_argument("-cutoff", type=float, default=0.45,
                   help="normalized cutoff (0..0.5 of the phase rate)")
    p.add_argument("-attenuation", type=float, default=120.0)
    p.add_argument("-interp", default="cubic",
                   choices=["none", "linear", "cubic"])
    p.add_argument("-show", type=int, default=8,
                   help="number of individual phases to print")
    args = p.parse_args(argv)

    from ..filterdesign import InterpolationOrder, design_polyphase_bank

    order = {"none": InterpolationOrder.NONE,
             "linear": InterpolationOrder.LINEAR,
             "cubic": InterpolationOrder.CUBIC}[args.interp]
    bank = design_polyphase_bank(args.phases, args.taps, args.cutoff,
                                 args.attenuation, order)
    gains = np.array([bank.phase_dc_gain(ph) for ph in range(bank.num_phases)])

    print(f"polyphase bank: {bank.num_phases} phases x "
          f"{bank.taps_per_phase} taps, cutoff {args.cutoff}, "
          f"attenuation {args.attenuation} dB, interp {args.interp}")
    print(f"DC gain: mean {gains.mean():.6f}  min {gains.min():.6f}  "
          f"max {gains.max():.6f}  spread {gains.max() - gains.min():.2e}")
    worst = int(np.argmax(np.abs(gains - 1.0)))
    print(f"worst phase: #{worst} (gain {gains[worst]:.6f}, "
          f"deviation {abs(gains[worst] - 1.0):.2e})")
    for ph in range(min(args.show, bank.num_phases)):
        bar = "#" * int(40 * min(gains[ph], 1.2) / 1.2)
        print(f"  phase {ph:3d}: {gains[ph]:.6f} {bar}")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
