"""resample: configuration info / demo tool.

Counterpart of the JAX package's ``cli/resample_info.py`` (the reference's
cmd/resample demo tool, cmd/resample/main.go:15-213): prints the selected
algorithm, filter length, phase count, latency, memory and backend for a
configuration, and ``-demo`` sweeps quality presets, common ratios and
channel counts.  ``-device`` picks where the resamplers are built: the
card by default (which raises without a GPU), or ``cpu``.

Usage:
    python -m go_audio_resampler_tpu_torch.cli.resample_info -in 44100 \
        -out 48000 -quality high
    python -m go_audio_resampler_tpu_torch.cli.resample_info -demo
"""

from __future__ import annotations

import argparse
import sys

_QUALITY_NAMES = {
    "quick": 0, "low": 1, "medium": 2, "high": 3, "veryhigh": 4,
    "very_high": 4, "vhq": 4,
}


def describe(in_rate: float, out_rate: float, quality_name: str,
             channels: int = 1, device: str = "cuda") -> str:
    from ..api import Config, QualityPreset, QualitySpec, new_resampler

    preset = QualityPreset(_QUALITY_NAMES[quality_name])
    r = new_resampler(Config(in_rate, out_rate, channels=channels,
                             quality=QualitySpec(preset=preset),
                             device=device))
    info = r.get_info()
    lines = [
        f"conversion:   {in_rate:.0f} Hz -> {out_rate:.0f} Hz "
        f"(ratio {r.get_ratio():.6f}), {channels} channel(s)",
        f"quality:      {quality_name}",
        f"algorithm:    {info.algorithm}",
        f"filter taps:  {info.filter_length}",
        f"phases:       {info.phases}",
        f"latency:      {info.latency} samples "
        f"({1000.0 * info.latency / in_rate:.2f} ms)",
        f"memory:       {info.memory_usage / 1024:.1f} KiB coefficients",
        f"backend:      {info.simd_type}",
    ]
    return "\n".join(lines)


def run(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="resample", description="Resampler configuration info tool")
    p.add_argument("-in", dest="in_rate", type=float, default=44100)
    p.add_argument("-out", dest="out_rate", type=float, default=48000)
    p.add_argument("-quality", default="high",
                   choices=sorted(set(_QUALITY_NAMES)))
    p.add_argument("-channels", type=int, default=1)
    p.add_argument("-demo", action="store_true",
                   help="sweep presets, ratios and channel counts")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the resamplers run (default cuda; cpu "
                        "where there is no GPU)")
    args = p.parse_args(argv)

    def show(*a, **kw):
        print(describe(*a, device=args.device, **kw))

    if not args.demo:
        show(args.in_rate, args.out_rate, args.quality, args.channels)
        return 0

    print("=== quality preset sweep (44.1 kHz -> 48 kHz) ===")
    for q in ("quick", "low", "medium", "high", "veryhigh"):
        print(f"\n-- {q} --")
        show(44100, 48000, q)
    print("\n=== ratio sweep (quality high) ===")
    for in_rate, out_rate in ((44100, 48000), (48000, 44100),
                              (96000, 48000), (48000, 96000),
                              (48000, 32000), (8000, 48000)):
        print(f"\n-- {in_rate} -> {out_rate} --")
        show(in_rate, out_rate, "high")
    print("\n=== channel count sweep (48k -> 44.1k, high) ===")
    for ch in (1, 2, 6, 8):
        print(f"\n-- {ch} channel(s) --")
        show(48000, 44100, "high", ch)
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
