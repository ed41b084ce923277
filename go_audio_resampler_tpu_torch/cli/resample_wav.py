"""resample-wav: WAV -> WAV sample-rate converter.

Counterpart of the JAX package's ``cli/resample_wav.py`` (the reference
CLI, cmd/resample-wav/main.go): streams the file in 65536-frame chunks
through the direct-engine path (the "maximum performance" path,
helpers.go:77-91) with all channels batched on the device, shows
progress every 10%, and reports realtime speed on completion.  Batch
mode (``-outdir``) resamples many files through the one-shot path, the
files of one rate and channel count sharing the stream axis.

Flags mirror the reference (main.go:94-100): -rate, -quality, -fast
(float32 engine), -parallel (accepted; batching is always on), -bits,
-v, -profile (a ``torch.profiler`` trace instead of pprof); plus
-dispatch and -precision (the engine's knobs), and -device: the card
(``cuda``, the default, which fails without a GPU) or ``cpu``.  Without
-fast the engine computes in ``api.default_dtype(device)``: float32 on
the card, float64 on the CPU.

Usage:
    python -m go_audio_resampler_tpu_torch.cli.resample_wav in.wav \
        out.wav -rate 48000 -quality high
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys
import time

import numpy as np

CHUNK_FRAMES = 65536  # streaming chunk size (main.go:38)
BATCH_GROUP_BYTES = 512 << 20  # cap on one padded batch-mode device matrix


def _flush_group(sub, plan, channels, args, outdir, WavWriter):
    """Resample one padded sub-batch and write each member's output."""
    from ..engine import oneshot

    n_max = max(d.shape[0] for _, _, d in sub)
    batch = np.zeros((len(sub) * channels, n_max), np.float32)
    for i, (_, _, d) in enumerate(sub):
        batch[i * channels:(i + 1) * channels, :d.shape[0]] = d.T
    y = oneshot(plan, batch, dtype=np.float32, device=args.device).cpu() \
        .numpy()
    for i, (path, bits, d) in enumerate(sub):
        count = plan.lengths.canonical(d.shape[0])
        out = y[i * channels:(i + 1) * channels, :count].T
        dest = outdir / pathlib.Path(path).name
        w = WavWriter(dest, int(args.rate), channels,
                      args.bits or (bits if bits in (16, 24, 32) else 16))
        w.write(out)
        w.close()
        if args.v:
            print(f"  {path} -> {dest} ({d.shape[0]} -> {count} frames)")


_QUALITY_NAMES = {
    "quick": 0, "low": 1, "medium": 2, "high": 3, "veryhigh": 4,
    "very_high": 4, "vhq": 4,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="resample-wav",
        description="High-quality WAV sample rate converter (PyTorch/CUDA)")
    p.add_argument("input", nargs="+",
                   help="input WAV file(s); with -outdir, many files are "
                        "resampled batched on the device's stream axis")
    p.add_argument("output", nargs="?", default=None,
                   help="output WAV file (single-file mode)")
    p.add_argument("-outdir", default=None,
                   help="batch mode: write outputs here, one per input")
    p.add_argument("-rate", type=float, default=48000,
                   help="output sample rate in Hz (default 48000)")
    p.add_argument("-quality", default="high",
                   choices=sorted(set(_QUALITY_NAMES)),
                   help="quality preset (default high)")
    p.add_argument("-fast", action="store_true",
                   help="use the float32 engine (~faster, slightly lower "
                        "precision)")
    p.add_argument("-parallel", action="store_true",
                   help="accepted for compatibility; channels are always "
                        "processed batched on the device")
    p.add_argument("-bits", type=str, default="0",
                   choices=["0", "16", "24", "32", "32f"],
                   help="output encoding: 16/24/32 integer PCM or 32f "
                        "(IEEE float32); default: match input depth as PCM")
    p.add_argument("-dispatch", default="auto",
                   choices=["auto", "pallas", "xla", "tune"],
                   help="banded-step lowering: auto (default) or pallas "
                        "(the CUDA kernel on the card), xla (its plain "
                        "PyTorch version), or tune (time both on the card "
                        "when the engine is built and pin the faster; "
                        "cached in $GAR_TUNE_CACHE_FILE)")
    p.add_argument("-precision", default="auto",
                   choices=["auto", "highest", "high", "default"],
                   help="matmul tier for the serving steps: auto "
                        "(process env), highest (exact f32), high "
                        "(3 bf16 passes), default (1 bf16 pass, the "
                        "ingest tier)")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (default cuda; cpu where "
                        "there is no GPU)")
    p.add_argument("-v", action="store_true", help="verbose output")
    p.add_argument("-profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace to DIR; wrap any "
                        "call in torch.profiler.profile, as this flag "
                        "does, to see the port's gar.* spans: "
                        "gar.engine.{process,process_device,fifo,h2d,"
                        "step,d2h,emit}, gar.functional.resample, "
                        "gar.oneshot.{aux,design,upload,apply}, "
                        "gar.banded.prepare, gar.k1, gar.k2, gar.k3 "
                        "(utils/spans.py)")
    return p


def run_batch(args, preset) -> int:
    """Batch mode: resample many files in one device program per group.

    Files are grouped by (sample_rate, channels); each group's channels
    ride the stream axis together (files padded to the sub-batch's
    longest, outputs trimmed per file to its canonical length).
    """
    from ..convenience import preset_to_engine_quality
    from ..engine import plan_engine
    from ..utils.wav import WavReader, WavWriter

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    seen_names = {}
    for path in args.input:
        name = pathlib.Path(path).name
        if name in seen_names:
            print(f"error: output name collision: {seen_names[name]!r} and "
                  f"{path!r} would both write {outdir / name}",
                  file=sys.stderr)
            return 1
        seen_names[name] = path
    t0 = time.perf_counter()
    files = []
    for path in args.input:
        try:
            r = WavReader(path)
        except (ValueError, IOError) as e:
            print(f"error: {path}: {e}", file=sys.stderr)
            return 1
        data = r.read(r.num_frames)      # [n, ch] float32
        r.close()
        files.append((path, r.sample_rate, r.bits, data))

    groups = {}
    for path, rate, bits, data in files:
        groups.setdefault((rate, data.shape[1]), []).append(
            (path, bits, data))

    total_frames = 0
    for (rate, channels), members in groups.items():
        plan = plan_engine(float(rate), float(args.rate),
                           preset_to_engine_quality(preset))
        # Length-sorted sub-batches under a fixed byte cap: padding is to
        # the sub-batch's longest member only.
        members = sorted(members, key=lambda m: m[2].shape[0])
        sub: list = []
        for member in members:
            n_max = max(member[2].shape[0],
                        sub[-1][2].shape[0] if sub else 0)
            if sub and (len(sub) + 1) * channels * n_max * 4 \
                    > BATCH_GROUP_BYTES:
                _flush_group(sub, plan, channels, args, outdir, WavWriter)
                sub = []
            sub.append(member)
        if sub:
            _flush_group(sub, plan, channels, args, outdir, WavWriter)
        total_frames += sum(d.shape[0] for _, _, d in members)
    elapsed = time.perf_counter() - t0
    print(f"batch: {len(files)} file(s), {total_frames} frames in "
          f"{elapsed:.2f} s")
    return 0


@contextlib.contextmanager
def _profiled(trace_dir: str | None, device: str):
    """A ``torch.profiler`` trace of the block, written to
    ``trace_dir/resample_wav.trace.json``; nothing where no directory
    is given."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    out = pathlib.Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "resample_wav.trace.json"))


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Normalize -bits: "0" = match input (falsy), "32f" = IEEE float32
    # (passed through to WavWriter as-is), else integer PCM depth.
    args.bits = (0 if args.bits == "0"
                 else args.bits if args.bits == "32f" else int(args.bits))

    import torch

    from ..api import QualityPreset, default_dtype
    from ..convenience import preset_to_engine_quality
    from ..engine import EngineCore, plan_engine
    from ..utils.wav import WavReader, WavWriter

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available; pass -device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1

    preset = QualityPreset(_QUALITY_NAMES[args.quality])

    # argparse's greedy nargs='+' consumes every positional; re-split here.
    positionals = list(args.input) + ([args.output] if args.output else [])
    if args.outdir is not None:
        if args.precision != "auto":
            # Batch mode runs the one-shot path, which follows the
            # process-wide tier; a per-engine pin would silently no-op.
            import os
            os.environ["GAR_TPU_MATMUL_PRECISION"] = args.precision
        args.input = positionals
        return run_batch(args, preset)
    if len(positionals) != 2:
        print("error: single-file mode needs exactly: input output "
              "(use -outdir for batch mode)", file=sys.stderr)
        return 2
    args.input, args.output = positionals

    dtype = np.float32 if args.fast else default_dtype(args.device)
    if dtype == np.float32 and not args.fast and args.v:
        print("note: float64 engine unavailable on this backend; "
              "using float32 (pass -fast to silence)")

    try:
        reader = WavReader(args.input)
    except (ValueError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    in_rate = reader.sample_rate
    out_rate = args.rate
    channels = reader.channels
    bits = args.bits or (reader.bits if reader.bits in (16, 24, 32) else 16)

    if args.v:
        print(f"input:  {args.input}: {in_rate} Hz, {channels} ch, "
              f"{reader.bits}-bit, {reader.num_frames} frames")
        print(f"output: {args.output}: {out_rate:.0f} Hz, {bits}-bit, "
              f"quality={args.quality}, engine="
              f"{'f32' if dtype == np.float32 else 'f64'}")

    if in_rate == out_rate:
        print("input and output rates are equal; copying")

    with _profiled(args.profile, args.device):
        plan = plan_engine(float(in_rate), float(out_rate),
                           preset_to_engine_quality(preset))
        engine = EngineCore(plan, batch=channels, block=8192, dtype=dtype,
                            dispatch=args.dispatch, precision=args.precision,
                            device=args.device)
        writer = WavWriter(args.output, int(out_rate), channels, bits)

        t0 = time.perf_counter()
        progress = {"frames": 0}

        def _chunks():
            # Generator feeding EngineCore.stream: the decode of chunk k+1
            # and the download of chunk k both overlap the device compute
            # (the reference's loop is serial read->compute->write,
            # cmd/resample-wav/main.go:270-339).
            while True:
                block = reader.read(CHUNK_FRAMES)    # [n, ch]
                if block.shape[0] == 0:
                    return
                progress["frames"] += block.shape[0]
                yield np.ascontiguousarray(block.T).astype(dtype)

        # Progress tracks WRITTEN output (decode runs ahead of compute in
        # the pipelined loop, so input-side progress would reach 100%
        # while the tail is still computing).
        out_total = (int(reader.num_frames * out_rate / in_rate)
                     if reader.num_frames else 0)
        written = 0
        next_pct = 10
        for y in engine.stream(_chunks()):
            writer.write(y.T)                        # [n_out, ch]
            written += y.shape[1]
            if args.v and out_total:
                pct = min(100 * written // out_total, 100)
                while pct >= next_pct and next_pct <= 100:
                    print(f"  {next_pct}%")
                    next_pct += 10
        frames_done = progress["frames"]
        writer.close()
        reader.close()
        elapsed = time.perf_counter() - t0
    audio_secs = frames_done / in_rate
    speed = audio_secs / elapsed if elapsed > 0 else float("inf")
    print(f"resampled {frames_done} frames ({audio_secs:.2f} s of audio) "
          f"in {elapsed:.2f} s ({speed:.1f}x realtime)")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
