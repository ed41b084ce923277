#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N]

Phases, each asserting (any failure exits non-zero, and no result line
is printed):

1. The card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel of the port from ``go_audio_resampler_tpu_torch/ops/csrc``
   (one nvcc per source, all started together).
2. Kernels: each kernel's wrapper (K1 ``fused_resample``, K2
   ``fused_resample_tmajor``, K3 ``general_resample``) against its plain
   PyTorch version on the card, at its path's shapes and at ragged ones,
   including offsets past 2^31 elements, then timed beside its plain
   version, one library call computing the same function (where there is
   one), and its bound on this card.
3. Main path: 44.1 kHz -> 48 kHz HIGH, ``EngineCore`` with 1024 streams of
   10 s each, fed through ``process_device`` one 2352-sample block at a
   time, then ``flush_device``.  Checks the exact output length, the
   kernel's launch count, 4 streams against the port's float64 CPU engine,
   and the THD of a 1 kHz sine stream against the -140 dB floor.
4. Time-major path: the same input, transposed, through
   ``TimeMajorEngine`` (K2) in 2352-row blocks: the same checks, and the
   output against the stream-major one.
5. Decimation path: 48 kHz -> 16 kHz HIGH, 256 streams of 10 s, through
   ``EngineCore.process_device`` (K1) and ``TimeMajorEngine`` (K2):
   lengths, launch counts, 4 streams against the float64 CPU engine.
6. One-shot: 64 streams of 2 s through ``oneshot`` for the general
   (K3), cubic (K3), rational (K1), decimation (K1) and DFT-upsampling
   (K1) topologies: lengths, launch counts, 4 streams against the port's
   float64 CPU ``oneshot``; host design, upload and device times apart.
7. Chunking: ``process()`` with random chunk splits equals
   ``process_device`` bit for bit.

Each path is driven with every launch count set to 0 just before it and
read just after; launches made to compare a kernel with its plain version
are not counted.  The last three lines are the card, the kernels as JSON,
and ``{"ok": true, "device": {...}}``.  Every time printed is this card's,
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
#: Decimation path: 48k -> 16k HIGH, 256 streams of 313 periods of 1536
#: input samples (10.016 s; the time-major engine takes whole periods).
DECIM_IN, DECIM_OUT = 48000, 16000
DECIM_STREAMS, DECIM_SAMPLES = 256, 313 * 1536
DECIM_CARRY = 1350                  # round_up(1349 taps - 1, 3)
#: One-shot phase: 64 streams of 2 s.
ONESHOT_STREAMS, ONESHOT_SECONDS = 64, 2


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


def device_kernels(fn, iters: int) -> list[tuple[str, float, float]]:
    """(name, device ms per call, launches per call) of every CUDA kernel
    that ``iters`` calls of ``fn`` ran, from ``torch.profiler``, the
    longest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / iters / 1e3, e.count / iters)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


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


def decim_operator():
    """(R_t float32 [wx, p2] on the card, ipx, wx, p2) of 48k -> 16k HIGH
    as the engines use it at block 2048 (superframed)."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    eng = EngineCore(plan_engine(DECIM_IN, DECIM_OUT, Quality.HIGH),
                     block=2048, device="cpu")
    r_t, ipx, wx, p2, _ = eng._band
    return r_t.to("cuda"), ipx, wx, p2


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


def bound(flops: int, bytes_: int) -> tuple[float, str]:
    """The least time (ms) of the work on this card, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, bytes_ / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k2_phase(gen) -> dict:
    """K2 against its plain version (and K1), then timed at the
    time-major path's shape."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch import Quality
    from go_audio_resampler_tpu_torch.ops import fused, tmajor

    def check(name, s, n_frames, rt, ipx, wx, p2, extra=0):
        r = rt.t().contiguous()
        xt = torch.randn(((n_frames - 1) * ipx + wx + extra, s),
                         generator=gen, device="cuda")
        y = tmajor.fused_resample_tmajor(xt, r, ipx=ipx, wx=wx, p2=p2,
                                         n_frames=n_frames)
        ref = tmajor.fused_resample_tmajor_reference(xt, r, ipx=ipx, wx=wx,
                                                     p2=p2, n_frames=n_frames)
        k1 = fused.fused_resample(xt.t().contiguous(), rt, ipx=ipx, wx=wx,
                                  p2=p2, n_frames=n_frames)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        same = bool(torch.equal(y, k1.t()))
        print(f"  K2 {name}: xT {tuple(xt.shape)}, R {tuple(r.shape)}, "
              f"{n_frames} frames, ipx {ipx}: max |kernel - plain| = "
              f"{err:.3g}; equal to K1 bit for bit: {same}")
        require(y.shape == (n_frames * p2, s) and math.isfinite(err),
                f"K2 {name}: shape {tuple(y.shape)}, error {err}")
        require(err <= KERNEL_TOL, f"K2 {name}: {err} > {KERNEL_TOL}")
        require(same, f"K2 {name}: differs from K1 on the same data")
        return xt, err

    rt, ipx, wx, p2 = operator(Quality.HIGH)
    n_frames = BLOCK // ipx
    carry = -(-(wx - ipx) // ipx) * ipx
    # The time-major path's step: [carry ++ block] = [294 + 2352, 1024].
    xt_main, err = check("time-major path", STREAMS, n_frames, rt, ipx, wx,
                         p2, extra=carry + BLOCK - ((n_frames - 1) * ipx + wx))
    require(tuple(xt_main.shape) == (2646, STREAMS), tuple(xt_main.shape))
    errs = [err]
    errs.append(check("ragged", 1000, 13, rt, ipx, wx, p2, extra=5)[1])
    errs.append(check("single frame", 3, 1, rt, ipx, wx, p2)[1])
    rt2, ipx2, wx2, p22 = operator(Quality.HIGH, RATE_OUT, RATE_IN)
    errs.append(check("48k->44.1k", 37, 20, rt2, ipx2, wx2, p22)[1])
    rt3, ipx3, wx3, p23 = operator(Quality.VERY_HIGH)
    errs.append(check("superframed VERY_HIGH", 129, 7, rt3, ipx3, wx3,
                      p23)[1])
    rt4, ipx4, wx4, p24 = decim_operator()
    # The decimation path's step: [carry ++ block] = [1350 + 3072, 256].
    errs.append(check("decimation path", DECIM_STREAMS, 2, rt4, ipx4, wx4,
                      p24, extra=DECIM_CARRY + ipx4 - wx4)[1])

    # Offsets past 2^31 elements: a [17e6, 128] input and its output.
    big_n = 17_000_000
    nfb = (big_n - wx) // ipx + 1
    r = rt.t().contiguous()
    xb = torch.empty((big_n, 128), device="cuda").normal_(generator=gen)
    yb = tmajor.fused_resample_tmajor(xb, r, ipx=ipx, wx=wx, p2=p2,
                                      n_frames=nfb)
    tail = 64
    f0 = nfb - tail
    ref = tmajor.fused_resample_tmajor_reference(
        xb[f0 * ipx:].contiguous(), r, ipx=ipx, wx=wx, p2=p2, n_frames=tail)
    err = (yb[f0 * p2:] - ref).abs().max().item()
    torch.cuda.synchronize()
    print(f"  K2 64-bit offsets: xT ({big_n}, 128), yT {tuple(yb.shape)}: "
          f"max |kernel - plain| over the last {tail} frames = {err:.3g}")
    require(xb.numel() > 2 ** 31 and yb.numel() > 2 ** 31
            and err <= KERNEL_TOL, f"K2 64-bit offsets: error {err}")
    errs.append(err)
    del xb, yb, ref
    torch.cuda.empty_cache()

    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=n_frames)
    # Library yardstick: conv1d on the stream-major copy (the transpose is
    # set-up, not timed).
    weight = rt.t().contiguous()[:, None, :]                  # [p2, 1, wx]
    lib_in = xt_main.t().contiguous()[:, None, :]
    lib = F.conv1d(lib_in, weight, stride=ipx)                # [S, p2, F]
    lib_err = (lib.permute(2, 1, 0).reshape(n_frames * p2, STREAMS)
               - tmajor.fused_resample_tmajor(xt_main, r, **kw)
               ).abs().max().item()
    require(lib_err <= KERNEL_TOL, f"conv1d disagrees with K2: {lib_err}")
    ms = cuda_ms(lambda: tmajor.fused_resample_tmajor(xt_main, r, **kw), 200)
    plain_ms = cuda_ms(lambda: tmajor.fused_resample_tmajor_reference(
        xt_main, r, **kw), 50)
    library_ms = cuda_ms(lambda: F.conv1d(lib_in, weight, stride=ipx), 50)
    nnz = int(torch.count_nonzero(rt).item())
    flops = 2 * nnz * STREAMS * n_frames
    bytes_ = 4 * (STREAMS * xt_main.shape[0] + wx * p2
                  + STREAMS * n_frames * p2)
    bound_ms, bound_by = bound(flops, bytes_)
    print(f"  K2 time-major shape: kernel {ms:.5f} ms, plain (unfold+matmul) "
          f"{plain_ms:.5f} ms, library (conv1d on the stream-major copy, "
          f"transpose not timed, TF32 off) {library_ms:.5f} ms; bound "
          f"{bound_ms:.5f} ms, {bound_by} ({flops} flops on the {nnz} "
          f"non-zeros of R, {bytes_} bytes); kernel reaches "
          f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of useful work")
    return {"name": "fused_resample_tmajor", "route": "cuda",
            "source": "go_audio_resampler_tpu_torch/ops/csrc/"
                      "fused_resample_tmajor.cu",
            "replaces": "go_audio_resampler_tpu/ops/pallas_fused.py:396",
            "launches": None, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def general_case(count_in: int = ONESHOT_SECONDS * RATE_IN):
    """(plan, starts, M [n_tiles, w, tile] float32 on the card, count) of
    the one-shot general path, 44.1 kHz -> 48.001 kHz HIGH."""
    import importlib
    import torch
    from go_audio_resampler_tpu_torch import Quality, plan_engine
    osm = importlib.import_module("go_audio_resampler_tpu_torch.engine.oneshot")
    plan = plan_engine(RATE_IN, 48001, Quality.HIGH)
    count = plan.lengths.canonical(count_in)
    starts, m = osm._upload(osm._general_matrices(plan, count),
                            torch.float32, "cuda")
    return plan, starts, m, count


def k3_phase(gen) -> dict:
    """K3 against its plain version, then timed at the one-shot general
    path's shape."""
    import torch
    from go_audio_resampler_tpu_torch.ops import general

    def check(name, x, m, starts, w_band, tile):
        y = general.general_resample(x, m, starts, w_band=w_band, tile=tile)
        ref = general.general_resample_reference(x, m, starts,
                                                 w_band=w_band, tile=tile)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        print(f"  K3 {name}: x {tuple(x.shape)}, M {tuple(m.shape)}, "
              f"w_band {w_band}, tile {tile}, starts {starts.dtype}: "
              f"max |kernel - plain| = {err:.3g}")
        require(y.shape == (x.shape[0], m.shape[0] * tile)
                and math.isfinite(err), f"K3 {name}: shape {tuple(y.shape)}")
        require(err <= KERNEL_TOL, f"K3 {name}: {err} > {KERNEL_TOL}")
        return err

    def random_case(s, n_tiles, w_band, tile, n):
        x = torch.randn((s, n), generator=gen, device="cuda")
        m = torch.randn((n_tiles, w_band, tile), generator=gen,
                        device="cuda") / math.sqrt(w_band)
        starts = torch.sort(torch.randint(-3, n - w_band // 2, (n_tiles,),
                                          generator=gen, device="cuda")).values
        return x, m, starts

    plan, starts, m, count = general_case()
    n_tiles, w_band, tile = m.shape
    i_last = int(starts[-1].item())
    x = 0.5 * torch.randn((ONESHOT_STREAMS, i_last + w_band), generator=gen,
                          device="cuda")
    errs = [check("one-shot general path", x, m, starts, w_band, tile)]
    errs.append(check("int32 starts", x, m, starts.int(), w_band, tile))
    errs.append(check("ragged streams and columns",
                      *random_case(65, 7, 17, 200, 500), 17, 200))
    errs.append(check("one tile, one stream",
                      *random_case(1, 1, 300, 256, 400), 300, 256))
    # Offsets past 2^31 elements: windows near the end of row 1 of a
    # [2, 1.2e9] input.
    big_n = 1_200_000_000
    xb = torch.empty((2, big_n), device="cuda").normal_(generator=gen)
    mb = torch.randn((4, 300, 256), generator=gen, device="cuda") / 17.0
    sb = torch.tensor([big_n - 2000, big_n - 1500, big_n - 700, big_n - 250],
                      device="cuda")
    yb = general.general_resample(xb, mb, sb, w_band=300, tile=256)
    lo = big_n - 2000
    ref = general.general_resample_reference(xb[1:, lo:].contiguous(), mb,
                                             sb - lo, w_band=300, tile=256)
    err = (yb[1:] - ref).abs().max().item()
    print(f"  K3 64-bit offsets: x (2, {big_n}), windows at the end of row "
          f"1: max |kernel - plain| = {err:.3g}")
    require(err <= KERNEL_TOL, f"K3 64-bit offsets: error {err}")
    errs.append(err)
    del xb, yb, ref
    torch.cuda.empty_cache()

    kw = dict(w_band=w_band, tile=tile)
    ms = cuda_ms(lambda: general.general_resample(x, m, starts, **kw), 50)
    plain_ms = cuda_ms(lambda: general.general_resample_reference(
        x, m, starts, **kw), 20)
    # No single PyTorch call computes K3; the nearest is one batched
    # product over frames already gathered (the gather not timed).
    idx = starts[:, None] + torch.arange(w_band, device="cuda")[None, :]
    frames = x[:, idx].permute(1, 0, 2).contiguous()          # [T, S, W]
    bmm_ms = cuda_ms(lambda: torch.bmm(frames, m), 50)
    nnz = int(torch.count_nonzero(m).item())
    flops = 2 * ONESHOT_STREAMS * nnz
    bytes_ = (4 * (m.numel() + x.numel() + ONESHOT_STREAMS * n_tiles * tile)
              + starts.numel() * starts.element_size())
    bound_ms, bound_by = bound(flops, bytes_)
    print(f"  K3 one-shot shape: kernel {ms:.5f} ms, plain (gather+einsum) "
          f"{plain_ms:.5f} ms, no single library call (nearest: torch.bmm "
          f"over the gathered frames, gather not timed, {bmm_ms:.5f} ms); "
          f"bound {bound_ms:.5f} ms, {bound_by} ({flops} flops on the {nnz} "
          f"non-zeros of M, {bytes_} bytes; M is {4 * m.numel()} bytes); "
          f"kernel reaches {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of "
          f"useful work")
    return {"name": "general_resample", "route": "cuda",
            "source": "go_audio_resampler_tpu_torch/ops/csrc/"
                      "general_resample.cu",
            "replaces": "go_audio_resampler_tpu/ops/pallas_fused.py:502",
            "launches": None, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def expected_launches(plan, n: int, n_chunks: int, ipx: int, p2: int,
                      block: int, drop: int) -> int:
    """Launches of a static-count engine fed ``n`` samples in ``n_chunks``
    chunks, then flushed: one per chunk, one for the flush tail of whole
    periods, and extra zero blocks while the core has not reached the
    canonical count."""
    lm = plan.lengths
    n1 = -(-lm.flush_pad(n) // ipx) * ipx
    core_out = (n + n1) // ipx * p2 - drop
    extra = max(0, -(-(lm.canonical(n) - core_out) // (block // ipx * p2)))
    return n_chunks + (1 if n1 else 0) + extra


def reset_launches() -> None:
    from go_audio_resampler_tpu_torch.ops import fused, general, tmajor
    fused.launches = tmajor.launches = general.launches = 0


def launch_counts() -> tuple[int, int, int]:
    """(K1, K2, K3) launches since the last reset."""
    from go_audio_resampler_tpu_torch.ops import fused, general, tmajor
    return fused.launches, tmajor.launches, general.launches


def main_path(gen, card: str) -> dict:
    """1024 streams x 10 s through the engine; returns K1's launches and
    what the time-major path compares with."""
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
    reset_launches()
    t0 = time.perf_counter()
    outs = [eng.process_device(x[:, a:b]) for a, b in chunks]
    outs.append(eng.flush_device())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k2, k3 = launch_counts()

    lm = plan.lengths
    canonical = lm.canonical(n)
    got_len = sum(o.shape[1] for o in outs)
    require(canonical == 480002 and got_len == canonical,
            f"output length {got_len}, canonical {canonical}")
    expected = expected_launches(plan, n, len(chunks), ipx, p2, BLOCK,
                                 eng._drop_override)
    require(launches == expected and (k2, k3) == (0, 0),
            f"launches K1 {launches} (expected {expected}), K2 {k2}, K3 {k3}")
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
    return {"launches": launches, "x": x, "y": torch.cat(outs, dim=1),
            "want": want, "rate": rate}


def tmajor_path(main: dict, card: str) -> int:
    """The main path's input, time-major, through ``TimeMajorEngine`` in
    2352-row blocks; returns K2's launches."""
    import torch
    from go_audio_resampler_tpu_torch import (Quality, TimeMajorEngine,
                                              plan_engine)
    from go_audio_resampler_tpu_torch.utils import metrics

    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    eng = TimeMajorEngine(plan, batch=STREAMS, block=BLOCK)
    require(eng.device.type == "cuda" and eng.block == BLOCK,
            f"engine on {eng.device}, block {eng.block}")
    xt = main["x"].t().contiguous()                  # [441000, 1024]
    n = xt.shape[0]
    canonical = plan.lengths.canonical(n)
    torch.empty((canonical + BLOCK, STREAMS), device="cuda")
    torch.cuda.synchronize()
    chunks = [(a, min(n, a + BLOCK)) for a in range(0, n, BLOCK)]
    reset_launches()
    t0 = time.perf_counter()
    outs = [eng.process_device(xt[a:b]) for a, b in chunks]
    outs.append(eng.flush_device())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, launches, k3 = launch_counts()

    y = torch.cat(outs, dim=0)
    require(tuple(y.shape) == (canonical, STREAMS) and canonical == 480002,
            f"time-major output {tuple(y.shape)}, canonical {canonical}")
    expected = expected_launches(plan, n, len(chunks), eng.chunk_multiple,
                                 eng._p2, BLOCK, eng._drop)
    require(launches == expected and (k1, k3) == (0, 0),
            f"launches K2 {launches} (expected {expected}), K1 {k1}, K3 {k3}")
    require(bool(torch.isfinite(y).all()), "non-finite output")
    got = y[:, :4].t().cpu().double().numpy()
    err = float(np.abs(got - main["want"]).max())
    vs_stream = (y.t() - main["y"]).abs().max().item()
    thd = metrics.thd(got[0], RATE_OUT, 1000.0, 16384)
    rate = STREAMS * n / wall / 1e6
    print(f"  time-major path: {STREAMS} streams x {n} samples in {wall:.4f} "
          f"s = {rate:.1f} Msamples/s in, {launches} K2 launches, "
          f"{len(chunks)} chunks ({wall / len(chunks) * 1e3:.4f} ms each) on "
          f"{card}")
    print(f"  time-major path: length {y.shape[0]} == canonical {canonical}; "
          f"max |cuda f32 - cpu f64| over 4 streams = {err:.3g}; max "
          f"|time-major - stream-major| = {vs_stream:.3g}; THD of the 1 kHz "
          f"stream = {thd:.2f} dB")
    require(err <= ENGINE_TOL, f"time-major vs float64: {err}")
    require(vs_stream <= ENGINE_TOL, f"time-major vs stream-major: {vs_stream}")
    require(thd <= THD_FLOOR_DB, f"THD {thd} dB > {THD_FLOOR_DB} dB")
    return launches


def decim_path(gen, card: str) -> tuple[int, int]:
    """48k -> 16k HIGH, 256 streams, through ``EngineCore`` (K1) and
    ``TimeMajorEngine`` (K2); returns (K1, K2) launches."""
    import torch
    from go_audio_resampler_tpu_torch import (EngineCore, Quality,
                                              TimeMajorEngine, plan_engine)

    plan = plan_engine(DECIM_IN, DECIM_OUT, Quality.HIGH)
    eng = EngineCore(plan, batch=DECIM_STREAMS, block=2048)
    tm = TimeMajorEngine(plan, batch=DECIM_STREAMS, block=2048)
    block, mult = eng.block, eng.device_chunk_multiple
    require((block, mult, tm.block, tm.chunk_multiple, eng._band.carry)
            == (3072, 1536, 3072, 1536, DECIM_CARRY),
            f"block {block}, multiple {mult}, carry {eng._band.carry}")
    n = DECIM_SAMPLES
    canonical = plan.lengths.canonical(n)
    x = 0.5 * torch.randn((DECIM_STREAMS, n), generator=gen, device="cuda")
    xt = x.t().contiguous()
    chunks = [(a, min(n, a + block)) for a in range(0, n, block)]
    expected = expected_launches(plan, n, len(chunks), mult,
                                 eng._band.p2, block, eng._drop_override)
    counts, walls, ys = [], [], []
    for e, data, dim in ((eng, lambda a, b: x[:, a:b], 1),
                         (tm, lambda a, b: xt[a:b], 0)):
        # Set-up, as on the main path: reserve the outputs' memory.
        torch.empty((DECIM_STREAMS, canonical + block), device="cuda")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs = [e.process_device(data(a, b)) for a, b in chunks]
        outs.append(e.flush_device())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(launch_counts())
        ys.append(torch.cat(outs, dim=dim))
    y, yt = ys
    require(tuple(y.shape) == (DECIM_STREAMS, canonical)
            and tuple(yt.shape) == (canonical, DECIM_STREAMS),
            f"decimation outputs {tuple(y.shape)}, {tuple(yt.shape)}, "
            f"canonical {canonical}")
    require(counts == [(expected, 0, 0), (0, expected, 0)],
            f"decimation launches {counts}, expected {expected} each")
    ref = EngineCore(plan, batch=4, block=2048, dtype=torch.float64,
                     device="cpu")
    x4 = x[:4].cpu().double().numpy()
    want = np.concatenate([ref.process(x4), ref.flush()], axis=1)
    err = float(np.abs(y[:4].cpu().double().numpy() - want).max())
    err_t = float(np.abs(yt[:, :4].t().cpu().double().numpy() - want).max())
    vs_stream = (yt.t() - y).abs().max().item()
    for name, wall, k in (("EngineCore (K1)", walls[0], expected),
                          ("TimeMajorEngine (K2)", walls[1], expected)):
        print(f"  decimation path, {name}: {DECIM_STREAMS} streams x {n} "
              f"samples in {wall:.4f} s = "
              f"{DECIM_STREAMS * n / wall / 1e6:.1f} Msamples/s in, {k} "
              f"launches, {len(chunks)} chunks on {card}")
    print(f"  decimation path: length {canonical} == canonical; max |cuda f32 "
          f"- cpu f64| over 4 streams = {err:.3g} (stream-major), "
          f"{err_t:.3g} (time-major); max |time-major - stream-major| = "
          f"{vs_stream:.3g}")
    require(max(err, err_t, vs_stream) <= ENGINE_TOL,
            f"decimation errors {err}, {err_t}, {vs_stream}")
    return counts[0][0], counts[1][1]


def oneshot_phase(gen, card: str) -> tuple[int, int]:
    """64 streams x 2 s through ``oneshot`` for five topologies; returns
    the (K1, K3) launches."""
    import importlib
    import torch
    from go_audio_resampler_tpu_torch import Quality, oneshot, plan_engine
    osm = importlib.import_module("go_audio_resampler_tpu_torch.engine.oneshot")

    cases = [  # name, plan, K1 and K3 launches of one call
        ("44.1k->48.001k HIGH (general, K3)",
         plan_engine(RATE_IN, 48001, Quality.HIGH), (0, 1)),
        ("44.1k->48k QUICK (cubic, K3)",
         plan_engine(RATE_IN, RATE_OUT, Quality.QUICK), (0, 1)),
        ("44.1k->48k HIGH (rational, K1)",
         plan_engine(RATE_IN, RATE_OUT, Quality.HIGH), (1, 0)),
        ("48k->16k HIGH (decimate, K1)",
         plan_engine(DECIM_IN, DECIM_OUT, Quality.HIGH), (1, 0)),
        ("48k->96k HIGH (dft_up, K1 through the banded convolution)",
         plan_engine(DECIM_IN, 96000, Quality.HIGH), (1, 0)),
    ]
    totals = [0, 0]
    for name, plan, (want_k1, want_k3) in cases:
        n = ONESHOT_SECONDS * int(plan.input_rate)
        canonical = plan.lengths.canonical(n)
        x = 0.5 * torch.randn((ONESHOT_STREAMS, n), generator=gen,
                              device="cuda")
        # Host design of the operators (cold host caches), then their
        # upload.
        osm._GENERAL_CACHE.clear()
        osm._GENERAL_CACHE_BYTES = 0
        osm._FUSED_CACHE.clear()
        osm._DECIM_CACHE.clear()
        t0 = time.perf_counter()
        if plan.kind == "two_stage" and not plan.is_rational_exact:
            host = osm._general_matrices(plan, canonical)
        elif plan.kind == "cubic":
            host = osm._cubic_matrices(plan, canonical)
        elif plan.kind == "two_stage":
            host = osm._fused_rational_matrix(plan)[:1]
        elif plan.kind == "decimate":
            host = osm._decim_matrix(plan, osm.PALLAS_DECIM_PERIOD)[:1]
        else:
            host = ()
        t1 = time.perf_counter()
        aux = osm._oneshot_aux(plan, n, torch.float32, torch.device("cuda"))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        # The entry point, as a user calls it.
        reset_launches()
        t3 = time.perf_counter()
        y = oneshot(plan, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t3
        k1, k2, k3 = launch_counts()
        require(y.device.type == "cuda" and y.dtype == torch.float32
                and tuple(y.shape) == (ONESHOT_STREAMS, canonical),
                f"{name}: output {tuple(y.shape)} {y.dtype}, canonical "
                f"{canonical}")
        require((k1, k2, k3) == (want_k1, 0, want_k3),
                f"{name}: launches K1 {k1}, K2 {k2}, K3 {k3}")
        require(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
        totals[0] += k1
        totals[1] += k3
        want = oneshot(plan, x[:4].cpu().double().numpy(), device="cpu")
        err = float(np.abs(y[:4].cpu().double().numpy()
                           - want.numpy()).max())
        # The device part alone, with the operators already uploaded: the
        # kernel's device time and every kernel's from torch.profiler, and
        # the span of the call on CUDA events (its host work included).
        def apply():
            return osm._oneshot_apply(plan, x, aux)

        span_ms = cuda_ms(apply, 10, warmup=1)
        kernels = device_kernels(apply, 5)
        kname = "general_resample_kernel(" if want_k3 else \
            "fused_resample_kernel("
        kernel_ms = sum(ms for key, ms, _ in kernels if kname in key)
        busy_ms = sum(ms for _, ms, _ in kernels)
        require(kernel_ms > 0, f"{name}: no {kname[:-1]} in the trace")
        mbytes = sum(a.nbytes for a in host) / 1e6
        print(f"  one-shot {name}: [{ONESHOT_STREAMS}, {n}] -> "
              f"{tuple(y.shape)} == canonical; launches K1 {k1}, K3 {k3}; "
              f"max |cuda f32 - cpu f64| over 4 streams = {err:.3g}; host "
              f"design {t1 - t0:.3f} s ({mbytes:.1f} MB of float64 "
              f"operators), upload {t2 - t1:.4f} s, entry point "
              f"{wall:.4f} s on {card}")
        print(f"  one-shot {name}: device {kname[:-1]} {kernel_ms:.5f} ms, "
              f"all kernels {busy_ms:.5f} ms (torch.profiler); "
              f"_oneshot_apply span {span_ms:.5f} ms (CUDA events)")
        for key, ms, count in kernels:
            print(f"  one-shot {name}: {ms:.5f} ms, {count:g} per call: "
                  f"{key[:80]}")
        require(err <= ENGINE_TOL, f"{name}: {err} > {ENGINE_TOL}")
    return totals[0], totals[1]




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
    """Where a warm step's time goes, on the main, time-major and
    decimation paths: host enqueue time, device time, and the device time
    of each kernel from ``torch.profiler``."""
    import torch
    from go_audio_resampler_tpu_torch import (EngineCore, Quality,
                                              TimeMajorEngine, plan_engine)

    cd_dat = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    decim = plan_engine(DECIM_IN, DECIM_OUT, Quality.HIGH)
    paths = [  # label, engine, streams, block, time-major
        ("main path", EngineCore(cd_dat, batch=STREAMS, block=BLOCK),
         STREAMS, BLOCK, False),
        ("time-major path", TimeMajorEngine(cd_dat, batch=STREAMS,
                                            block=BLOCK),
         STREAMS, BLOCK, True),
        ("decimation path", EngineCore(decim, batch=DECIM_STREAMS,
                                       block=2048),
         DECIM_STREAMS, 3072, False),
    ]
    for label, eng, s, blk, tmaj in paths:
        x = torch.empty((s, steps * blk), device="cuda").normal_(
            generator=gen)
        if tmaj:
            x = x.t().contiguous()

        def run():
            return [eng.process_device(x[i * blk:(i + 1) * blk] if tmaj
                                       else x[:, i * blk:(i + 1) * blk])
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
        kernels = device_kernels(run, 1)
        busy = sum(ms for _, ms, _ in kernels) / steps
        print(f"  profile, {label}: {steps} warm steps of {s} streams x "
              f"{blk}: host enqueue {(t1 - t0) / steps * 1e3:.5f} ms/step, "
              f"wall {wall:.5f} ms/step, device {device:.5f} ms/step; "
              f"kernels busy {busy:.5f} ms/step under the profiler (device "
              f"idle share {max(0.0, 1 - busy / wall):.3f})")
        for name, ms, count in kernels:
            print(f"  profile, {label}: {ms / steps:.5f} ms/step, "
                  f"{count / steps:g} per step: {name[:90]}")
        del x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile warm steps of the main, "
                         "time-major and decimation paths (where the time "
                         "goes)")
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
    sources = ["fused_resample", "fused_resample_tmajor", "general_resample"]
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
    k2 = k2_phase(gen)
    k3 = k3_phase(gen)
    print("main path:")
    main_run = main_path(gen, card)
    k1["launches"] = main_run["launches"]
    print("time-major path:")
    k2["launches"] = tmajor_path(main_run, card)
    del main_run
    torch.cuda.empty_cache()
    print("decimation path:")
    decim_k1, decim_k2 = decim_path(gen, card)
    print("one-shot:")
    oneshot_k1, k3["launches"] = oneshot_phase(gen, card)
    print(f"  launches by path: K1 {k1['launches']} (main path), "
          f"{decim_k1} (decimation), {oneshot_k1} (one-shot); K2 "
          f"{k2['launches']} (time-major), {decim_k2} (decimation); K3 "
          f"{k3['launches']} (one-shot)")
    print("chunking:")
    chunking_phase(args.seed)
    if args.profile:
        print("profile:")
        profile_phase(gen)

    print(card)
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
