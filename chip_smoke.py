#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N]

Phases, each asserting (any failure exits non-zero, and no result line
is printed):

1. The card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel of the port from ``go_audio_resampler_tpu_torch/ops/csrc``.
2. Kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the main path's shapes and at ragged ones, then timed beside
   its plain version, one library call computing the same function, and
   its bound on this card.
3. Main path: 44.1 kHz -> 48 kHz HIGH, ``EngineCore`` with 1024 streams of
   10 s each, fed through ``process_device`` one 2352-sample block at a
   time, then ``flush_device``.  Checks the exact output length, the
   kernel's launch count, 4 streams against the port's float64 CPU engine,
   and the THD of a 1 kHz sine stream against the -140 dB floor.
4. Chunking: ``process()`` with random chunk splits equals
   ``process_device`` bit for bit.

The last three lines are the card, the kernels as JSON, and
``{"ok": true, "device": {...}}``.  Every time printed is this card's,
measured in this run.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

#: Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
#: tensor cores, and HBM3 bandwidth.  Bounds below are stated against them.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: Tolerances: float32 kernel vs its float32 plain version (different
#: summation order), and float32 engine vs the float64 CPU engine.
KERNEL_TOL = 2e-5
ENGINE_TOL = 2e-5
THD_FLOOR_DB = -140.0          # QUALITY_tpu.json thd_44k_48k_high_db floor

RATE_IN, RATE_OUT = 44100, 48000
STREAMS, SECONDS, BLOCK = 1024, 10, 2352


def require(ok, what="check failed") -> None:
    """Fail the run (also under ``python -O``, which strips asserts)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    require(out, "nvidia-smi printed no card")
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def operator(q, rate_in=RATE_IN, rate_out=RATE_OUT, block=BLOCK):
    """(R_t float32 [wx, p2] on the card, ipx, wx, p2) as the engine uses it."""
    import torch
    from go_audio_resampler_tpu_torch.engine.oneshot import (
        _fused_rational_matrix, superframe)
    from go_audio_resampler_tpu_torch.engine.plan import plan_engine
    r, _, ipx, _ = _fused_rational_matrix(plan_engine(rate_in, rate_out, q))
    r, ipx = superframe(r, ipx, kf_cap=max(1, block // ipx))
    rt = torch.as_tensor(np.ascontiguousarray(r.T), dtype=torch.float32,
                         device="cuda")
    return rt, ipx, r.shape[1], r.shape[0]


def kernel_phase(gen) -> dict:
    """K1 against its plain version, then timed at the main-path shape."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch import Quality
    from go_audio_resampler_tpu_torch.ops import fused

    def check(name, s, n_frames, rt, ipx, wx, p2, extra=0):
        x = torch.randn((s, (n_frames - 1) * ipx + wx + extra),
                        generator=gen, device="cuda")
        y = fused.fused_resample(x, rt, ipx=ipx, wx=wx, p2=p2,
                                 n_frames=n_frames)
        ref = fused.fused_resample_reference(x, rt, ipx=ipx, wx=wx, p2=p2,
                                             n_frames=n_frames)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        print(f"  K1 {name}: data {tuple(x.shape)}, R_t {tuple(rt.shape)}, "
              f"{n_frames} frames, ipx {ipx}: max |kernel - plain| = {err:.3g}")
        require(y.shape == (s, n_frames * p2) and math.isfinite(err),
                f"K1 {name}: shape {tuple(y.shape)}, error {err}")
        require(err <= KERNEL_TOL, f"K1 {name}: {err} > {KERNEL_TOL}")
        return x, err

    rt, ipx, wx, p2 = operator(Quality.HIGH)
    require((tuple(rt.shape), ipx) == ((343, 160), 147), (rt.shape, ipx))
    n_frames = BLOCK // ipx
    carry = -(-(wx - ipx) // ipx) * ipx
    # The main-path step: [carry ++ block] = [1024, 294 + 2352].
    x_main, err = check("main path", STREAMS, n_frames, rt, ipx, wx, p2,
                        extra=carry + BLOCK - ((n_frames - 1) * ipx + wx))
    require(tuple(x_main.shape) == (STREAMS, 2646), tuple(x_main.shape))
    errs = [err]
    errs.append(check("ragged", 5, 13, rt, ipx, wx, p2, extra=5)[1])
    rt2, ipx2, wx2, p22 = operator(Quality.HIGH, RATE_OUT, RATE_IN)
    require((tuple(rt2.shape), ipx2) == ((351, 147), 160), (rt2.shape, ipx2))
    errs.append(check("48k->44.1k", 37, 20, rt2, ipx2, wx2, p22)[1])
    rt3, ipx3, wx3, p23 = operator(Quality.VERY_HIGH)
    errs.append(check("superframed VERY_HIGH", 9, 11, rt3, ipx3, wx3, p23)[1])

    # Offsets past 2^31 elements: row 1 of a [2, 1.2e9] input ends beyond
    # 2^31, and so does its output; the tail frames are checked.
    big_n = 1_200_000_000
    nfb = (big_n - wx) // ipx + 1
    xb = torch.empty((2, big_n), device="cuda").normal_(generator=gen)
    yb = fused.fused_resample(xb, rt, ipx=ipx, wx=wx, p2=p2, n_frames=nfb)
    tail = 64
    f0 = nfb - tail
    ref = fused.fused_resample_reference(
        xb[1:, f0 * ipx:].contiguous(), rt, ipx=ipx, wx=wx, p2=p2,
        n_frames=tail)
    err = (yb[1:, f0 * p2:] - ref).abs().max().item()
    torch.cuda.synchronize()
    print(f"  K1 64-bit offsets: data (2, {big_n}), y {tuple(yb.shape)}: "
          f"max |kernel - plain| over the last {tail} frames = {err:.3g}")
    require(yb.numel() > 2 ** 31 and err <= KERNEL_TOL,
            f"K1 64-bit offsets: error {err}")
    errs.append(err)
    del xb, yb, ref
    torch.cuda.empty_cache()

    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=n_frames)
    weight = rt.t().contiguous()[:, None, :]                  # [p2, 1, wx]
    lib_in = x_main[:, None, :(n_frames - 1) * ipx + wx].contiguous()
    lib = F.conv1d(lib_in, weight, stride=ipx)                # [S, p2, F]
    lib_err = (lib.transpose(1, 2).reshape(STREAMS, -1)
               - fused.fused_resample(x_main, rt, **kw)).abs().max().item()
    require(lib_err <= KERNEL_TOL, f"conv1d disagrees: {lib_err}")
    ms = cuda_ms(lambda: fused.fused_resample(x_main, rt, **kw), 200)
    plain_ms = cuda_ms(
        lambda: fused.fused_resample_reference(x_main, rt, **kw), 50)
    library_ms = cuda_ms(lambda: F.conv1d(lib_in, weight, stride=ipx), 50)
    nnz = int(torch.count_nonzero(rt).item())
    flops = 2 * nnz * STREAMS * n_frames
    bytes_ = 4 * (STREAMS * ((n_frames - 1) * ipx + wx) + wx * p2
                  + STREAMS * n_frames * p2)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, bytes_ / PEAK_HBM_BYTES * 1e3
    dense_ms = 2 * wx * p2 * STREAMS * n_frames / PEAK_F32_FLOPS * 1e3
    print(f"  K1 main shape: kernel {ms:.5f} ms, plain (unfold+matmul) "
          f"{plain_ms:.5f} ms, library (conv1d, TF32 off) {library_ms:.5f} "
          f"ms; bound {max(t_ops, t_bytes):.5f} ms ({flops} flops on the "
          f"{nnz} non-zeros of R_t, {bytes_} bytes; dense product "
          f"{dense_ms:.5f} ms); kernel reaches "
          f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of useful work")
    return {"name": "fused_resample", "route": "cuda",
            "source": "go_audio_resampler_tpu_torch/ops/csrc/"
                      "fused_resample.cu",
            "replaces": "go_audio_resampler_tpu/ops/pallas_fused.py:210",
            "launches": None, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def main_path(gen, card: str) -> int:
    """1024 streams x 10 s through the engine; returns K1's launches."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.ops import fused
    from go_audio_resampler_tpu_torch.utils import metrics, signals

    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    eng = EngineCore(plan, batch=STREAMS, block=BLOCK, dtype=torch.float32)
    require(eng.device.type == "cuda" and eng.block == BLOCK,
            f"engine on {eng.device}, block {eng.block}")
    ipx, p2 = eng._device_params()
    n = RATE_IN * SECONDS
    x = torch.empty((STREAMS, n), device="cuda").normal_(generator=gen)
    x *= 0.5
    x[0] = torch.as_tensor(signals.sine(n, 1000.0, RATE_IN),
                           dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()

    chunks = [(a, min(n, a + BLOCK)) for a in range(0, n, BLOCK)]
    # Set-up: reserve the outputs' memory in PyTorch's caching allocator,
    # as a long-running process has it, so the run does not time
    # cudaMalloc growing the pool chunk by chunk.
    torch.empty((STREAMS, plan.lengths.canonical(n) + BLOCK),
                device="cuda")
    fused.launches = 0
    t0 = time.perf_counter()
    outs = [eng.process_device(x[:, a:b]) for a, b in chunks]
    outs.append(eng.flush_device())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.launches

    lm = plan.lengths
    canonical = lm.canonical(n)
    got_len = sum(o.shape[1] for o in outs)
    require(canonical == 480002 and got_len == canonical,
            f"output length {got_len}, canonical {canonical}")
    # One launch per chunk, then the flush: the tail of whole periods, and
    # extra zero blocks while the core has not reached the canonical count.
    n1 = -(-lm.flush_pad(n) // ipx) * ipx
    core_out = (n + n1) // ipx * p2 - eng._drop_override
    extra = max(0, -(-(canonical - core_out) // (BLOCK // ipx * p2)))
    expected = len(chunks) + 1 + extra
    require(launches == expected, f"K1 launches {launches} != {expected}")
    require(all(bool(torch.isfinite(o).all()) for o in outs),
            "non-finite output")

    ref = EngineCore(plan, batch=4, block=BLOCK, dtype=torch.float64,
                     device="cpu")
    x4 = x[:4].cpu().double().numpy()
    want = np.concatenate([ref.process(x4), ref.flush()], axis=1)
    got = torch.cat([o[:4] for o in outs], dim=1).cpu().double().numpy()
    require(got.shape == want.shape == (4, canonical),
            f"shapes {got.shape} and {want.shape}")
    err = float(np.abs(got - want).max())
    thd = metrics.thd(got[0], RATE_OUT, 1000.0, 16384)
    rate = STREAMS * n / wall / 1e6
    print(f"  main path: {STREAMS} streams x {n} samples in {wall:.4f} s = "
          f"{rate:.1f} Msamples/s in ({STREAMS * canonical / wall / 1e6:.1f} "
          f"out), {launches} K1 launches, {len(chunks)} chunks "
          f"({wall / len(chunks) * 1e3:.4f} ms each) on {card}")
    print(f"  main path: length {got_len} == canonical {canonical}; "
          f"max |cuda f32 - cpu f64| over 4 streams = {err:.3g}; "
          f"THD of the 1 kHz stream = {thd:.2f} dB")
    require(err <= ENGINE_TOL, f"engine vs float64: {err} > {ENGINE_TOL}")
    require(thd <= THD_FLOOR_DB, f"THD {thd} dB > {THD_FLOOR_DB} dB")
    return launches


def chunking_phase(seed: int) -> None:
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine

    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 147 * 200)).astype(np.float32)
    a = EngineCore(plan, batch=8, block=BLOCK, dtype=torch.float32)
    parts, at = [], 0
    while at < x.shape[1]:
        step = int(rng.integers(1, 3 * BLOCK))
        parts.append(a.process(x[:, at:at + step]))
        at += step
    ya = np.concatenate(parts + [a.flush()], axis=1)
    b = EngineCore(plan, batch=8, block=BLOCK, dtype=torch.float32)
    yb = torch.cat([b.process_device(torch.from_numpy(x).cuda()),
                    b.flush_device()], dim=1).cpu().numpy()
    require(ya.shape == yb.shape == (8, plan.lengths.canonical(x.shape[1])),
            f"chunking shapes {ya.shape} and {yb.shape}")
    require(np.array_equal(ya, yb), "process() and process_device() differ")
    print(f"  chunking: {len(parts)} random chunks through process() == one "
          f"process_device() chunk, bit for bit ({ya.shape[1]} samples)")


def profile_phase(gen, steps: int = 40) -> None:
    """Where a warm main-path step's time goes: host enqueue time, device
    time, and the device time of each kernel from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine

    eng = EngineCore(plan_engine(RATE_IN, RATE_OUT, Quality.HIGH),
                     batch=STREAMS, block=BLOCK, dtype=torch.float32)
    x = torch.empty((STREAMS, steps * BLOCK), device="cuda").normal_(
        generator=gen)

    def run():
        return [eng.process_device(x[:, i * BLOCK:(i + 1) * BLOCK])
                for i in range(steps)]

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run()
    t1 = time.perf_counter()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    device = start.elapsed_time(end) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    print(f"  profile: {steps} warm steps of [{STREAMS}, {BLOCK}]: host "
          f"enqueue {(t1 - t0) / steps * 1e3:.5f} ms/step, wall "
          f"{wall:.5f} ms/step, device {device:.5f} ms/step; kernels busy "
          f"{busy:.5f} ms/step under the profiler (device idle share "
          f"{max(0.0, 1 - busy / wall):.3f})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        print(f"  profile: {e.self_device_time_total / steps / 1e3:.5f} "
              f"ms/step, {e.count / steps:g} per step: {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile warm main-path steps (where the "
                         "time goes)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from go_audio_resampler_tpu_torch.ops import _build

    # The plain versions are the oracle: full float32, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sources = ["fused_resample"]
    _build.build_all(sources)
    print(f"build: {len(sources)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in _build.PTXAS_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    print("kernels:")
    k1 = kernel_phase(gen)
    print("main path:")
    k1["launches"] = main_path(gen, card)
    print("chunking:")
    chunking_phase(args.seed)
    if args.profile:
        print("profile:")
        profile_phase(gen)

    print(card)
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
