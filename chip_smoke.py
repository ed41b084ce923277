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
   PyTorch version on the card, at its paths' shapes and at ragged ones,
   including offsets past 2^31 elements, then timed beside its plain
   version, the library calls computing the same function (where there
   are any), and its bounds on this card.  K1 and K2 are checked and timed
   at the main path's shape and at the decimation path's, with their
   float32-FMA and 3xTF32 tensor-core bounds and their work counted on R's
   non-zeros and on the kernels' band-limited walk.  K3 is checked and
   timed at the one-shot general and cubic shapes, with its 3xTF32 bound
   on M's non-zeros beside the dense-M one, its bands' share of the dense
   product and ``torch.bmm`` over the gathered frames.
3. Main path: 44.1 kHz -> 48 kHz HIGH, ``EngineCore`` with 1024 streams of
   10 s each, fed through ``process_device`` one 2352-sample block at a
   time, then ``flush_device``.  Checks the exact output length, the
   kernel's launch count, 4 streams against the port's float64 CPU engine,
   and the THD of a 1 kHz sine stream against the -140 dB floor.
4. Time-major path: the same input, transposed, through
   ``TimeMajorEngine`` (K2) in 2352-row blocks: the same checks, and the
   output against the stream-major one.
5. Decimation path: 48 kHz -> 16 kHz HIGH, 256 streams of 10 s, through
   ``EngineCore.process_device`` (K1) and ``TimeMajorEngine`` (K2), each
   run cold (from an emptied allocator cache, which grows its pool for
   the step outputs) and warm (the pool cached), with each step's host
   time: lengths, launch counts of each run, 4 streams against the
   float64 CPU engine.
6. One-shot: 64 streams of 2 s through ``oneshot`` for the general
   (K3), cubic (K3), rational (K1), decimation (K1) and DFT-upsampling
   (K1) topologies: lengths, launch counts, 4 streams against the port's
   float64 CPU ``oneshot``; host design, upload and device times apart.
7. Chunking: ``process()`` with random chunk splits equals
   ``process_device`` bit for bit.
8. Precision tiers ('high': three bf16 passes, 'default': one;
   ``ops/precision.py``), each: K1 and K2 at the main and decimation
   shapes and K3 at the general and cubic shapes (both block widths)
   against their plain versions at the tier, within 2e-5 of max|y|, K2
   equal to K1 bit for bit, timed beside the plain version, ``torch.matmul``
   (``torch.bmm`` for K3) on bf16 operands and the tier's bounds; the
   one-shot general path with ``GAR_TPU_MATMUL_PRECISION`` set to the tier
   (one K3 launch, within the tier's bound of the float64 CPU run); the
   main path's input through ``EngineCore`` and ``TimeMajorEngine`` at the
   tier (190 launches each, equal bit for bit, within the tier's bound of
   the float64 CPU run, the tier's THD pin on the 1 kHz stream); and the
   dispatch gate: 'auto' and 'pallas' launch the kernel, 'xla' and
   ``force_xla`` launch none and give the plain version's bits.
9. General walk: 44.1 kHz -> 48.001 kHz HIGH (a non-exact ratio),
   ``EngineCore`` with 256 streams of 10 s at block 2048, fed through
   ``process()`` in random chunks, then ``flush()``: the exact length, one
   K1 launch (the 2x prestage) a block step and no K2 or K3, 4 streams
   against the float64 CPU engine, THD of a 1 kHz stream (<= -85 dB; <=
   -120 dB with ``hq_interp``), the walk against the one-shot (K3) of
   phase 6's general input, the banded emit against the gather emit on
   one block's state, no K1 launch under ``force_xla``; K1 at the walk's
   prestage shape against its plain version, timed beside it and
   ``F.conv1d``; host and device time of warm steps (with ``--profile``
   K1 apart from the emit).
10. dft_up and cubic: 48 kHz -> 96 kHz HIGH through ``process_device`` /
   ``flush_device`` (exact K1 launches) and through ``process()``, equal
   bit for bit; 44.1 kHz -> 48 kHz QUICK (cubic, no kernel) through
   ``process()``; 256 streams of 2 s each, lengths and 4 streams against
   the float64 CPU engine.
11. Strict antialias and banded composites, each K1 or K2 shape first
   checked against its plain version (within 2e-5 of max|y|, at the step's
   shape and a ragged one) and timed beside it, ``F.conv1d`` and
   ``matmul`` on the ``unfold`` view:
   A. 96 kHz -> 44.1 kHz HIGH, the banded composite the API fuses
      (``fuse_chain`` of a 2x decimator and 48k -> 44.1k with the
      prefilter; a 294-row head), 256 streams x 10 s through
      ``EngineCore.process_device`` in 3200-sample blocks and through
      ``process()`` in random chunks: exact length, the two routes equal
      bit for bit, K1 launches derived from the block count and no K2 or
      K3, 4 streams within 2e-5 of max|y| of the float64 CPU engine and
      the first 294 outputs against the float64 head rows, THD of a 1 kHz
      stream <= -130 dB, a 30 kHz tone rejected by >= 100 dB; warm steps
      with each kernel's device time (``torch.profiler``);
      ``TimeMajorEngine`` refuses it;
   B. 48k -> 44.1k HIGH with the prefilter composed in, 1024 streams x
      10 s: the same checks, THD <= -140 dB;
   C. 192 kHz -> 48 kHz HIGH (head-free composite), 256 streams x 10.003 s
      through ``TimeMajorEngine`` (K2, equal to K1 bit for bit at its
      shape) and ``EngineCore``: equal within 2e-5 of max|y|, exact
      lengths and launches, 4 streams against float64;
   D. 48k -> 44.099k HIGH, the walk behind the prefilter, 256 streams x
      2 s through ``process()``: K1 launches derived (the prefilter's and
      the prestage's, each one a block), 4 streams against float64, the
      stream within 5e-6 of max|y| of its one-shot;
   E. ``oneshot`` of B (K1 with lam) and D (the prefilter on K1, then
      K3), 64 streams x 2 s: exact launches, 4 streams against the
      float64 CPU ``oneshot``.

12. Public API and FFT routes (256 channels, ``MAX_CHANNELS``, of 10 s
   unless said otherwise; each sub-path prints its wall time, input
   Msamples/s, device span, launches and its comparison):
   API-A. 44.1k -> 48k HIGH through ``new_resampler(Config(...,
      dtype=float32, max_input_size=2352))``: ``process_multi_device`` /
      ``flush_multi_device`` equal bit for bit to ``EngineCore`` on the
      Resampler's own plan at block 2352, to ``process_multi`` and to
      ``stream_multi(out='host')``; derived K1 launches; 4 channels
      within 2e-5 of max|y| of the float64 CPU run; THD <= -140 dB;
   API-B. 96k -> 44.1k HIGH (auto strict antialias, the composite with
      head rows): whether its stage plans equal phase 11's (then bit for
      bit against phase 11's composite engine); within 2e-5 of max|y| of
      the float64 CPU run; THD <= -130 dB, the 30 kHz tone rejected by
      >= 100 dB;
   API-C. 48k -> 16k HIGH (a half-band and a polyphase stage fused): K1
      at its step's shape against its plain version, timed beside
      ``F.conv1d`` with its bound; the device route against float64;
   API-D. 44.1k -> 3001 VERY_HIGH (a composite, then the walk behind its
      prefilter): ``process_multi``/``flush_multi`` against float64;
      ``process_multi_device`` refuses with the JAX diagnostic;
   convenience: ``resample_stereo`` 44.1k -> 48k (K1) and
      ``resample_mono`` 44.1k -> 48.001k (K3), 1 s, against float64;
      ``new_engine_float32`` equal bit for bit to ``EngineCore``;
   FFT-1. ``fft_oneshot`` (cuFFT) within 1e-5 of max|y| of ``oneshot``
      (K1), 64 x 2 s, decimate 96k -> 48k VERY_HIGH and dft_up 48k -> 96k
      HIGH, with each route's kernels' device time;
   FFT-2. ``EngineCore`` of 44.1k -> 3001 VERY_HIGH strict (the 7,841-tap
      prefilter by overlap-save) through ``process()``: one K1 launch (the
      prestage) a block, against float64, the prefilter's step time;
   FFT-3. the FFT decimation step (``DECIM_FFT_MIN_TAPS`` lowered for
      this sub-phase only), 96k -> 48k VERY_HIGH, 469 blocks of 2048:
      ``process_device`` equal bit for bit to ``process()`` at the same
      blocks, both within 1e-5 of max|y| of the K1 route;
      ``TimeMajorEngine`` refuses it.

13. Variable rate, checkpoints, the functional op and the shims:
   VR. Drift correction: ``VariableRateResampler`` (max_ratio 2.0, io_ratio
      48000/47990, slewed to 48000/48010 over 48000 outputs from block 117
      on), 256 streams x 235 blocks of 2048 at 48 kHz (10.03 s), 'vr' and
      'vr-hq', each through ``process()`` in two random chunkings and
      through ``process_device``: the three equal bit for bit, 4 streams
      within 2e-5 of max|y| of the float64 CPU run, K1 launches derived
      from the block count (one a block for 'vr-hq', none for 'vr'), the
      0.2 fs tone's residual cut by >= 20 dB by 'vr-hq'; each route's
      Msamples/s in and ms a block, warm steps' host enqueue and kernels'
      device time (``torch.profiler``); K1 at the prestage's shape.
   Checkpoint. Saved mid-stream and restored into a fresh object, which
      goes on bit for bit equal to the whole run: the main path's
      ``EngineCore`` (1024 x 10 s), the 96k -> 44.1k composite inside its
      head region (256 x 10 s), an API-A ``Resampler`` (256 x 10 s), and
      the 'vr-hq' stream mid-slew; save and load ms.
   Functional. ``functional.resample`` on 64 x 2 s: 48k -> 16k and 44.1k
      -> 48k equal to ``oneshot`` bit for bit with one K1 launch, 44.1k ->
      48.001k (the block loop) within 2e-5 of max|y| of phase 6's K3
      output with one K1 launch a block; the adjoint identity to 1e-5 of
      |y| |w|, no launch in the backward; forward and backward ms; five
      Adam steps of a ``Conv1d`` front end reduce its loss; K1 at the
      decimation operator's and the block loop's prestage shapes.
   Shims. ``soxr_compat.resample`` (2 ch x 10 s, 44.1k -> 48k HQ, numpy)
      and ``torch_compat.Resample`` (48k -> 44.1k, a [64, 96000] tensor on
      the card) equal to ``oneshot`` bit for bit, one K1 launch each; K1
      at both shapes.
14. Sharding, the CLI, the quality tool and the roofline.
   Sharding at world size 1 on a one-rank ``nccl`` group (``parallel``).
      ``ShardedEngineCore`` on the main path (1024 x 10 s, block 2352,
      ``process_device``): equal to ``EngineCore`` bit for bit, 190 K1
      launches, ``DTensor`` outputs with ``Shard(0)``; Msamples/s in and
      host enqueue a step of both, in warm runs taken in turns.
      ``sharded_stream_step``: the exact branch on 1024 streams (one K1
      launch a step, within 2e-5 of ``oneshot`` after the ramp, the MAX
      all-reduce's peak equal to max|y|) and the walk (44.1k -> 48.001k,
      256 streams, within 2e-5 of the serial walk); ``sharded_oneshot``
      on 64 x 2 s, rational (K1) and general (K3), equal to ``oneshot`` bit
      for bit; ``global_stream_stats`` against torch; the sharded VR,
      'vr' and 'vr-hq' (256 x 10.03 s), equal to the serial one bit for
      bit.
   CLI. ``resample_wav`` on a 5-minute stereo 24-bit 44.1 kHz file (a 1
      kHz tone and noise from ``--seed``) to 48 kHz HIGH on the default
      device: the canonical length, bit for bit ``EngineCore.stream`` on
      the decoded input written the same way, channel 0's THD <= -130
      dB, the realtime factor, K1 at its step shape; batch mode on 32
      stereo files of 5-60 s, each equal to ``oneshot`` of its own file
      bit for bit, K1 at the largest sub-batch; ``resample_info`` and
      ``analyze_filter`` exit 0; the native WAV library loads.
   Quality. ``tools/quality_cuda.py``'s full check set, every check
      passing, on one JSON line.
   Roofline. ``roofline.analyze`` of the main path's and the sharded
      engine's Msamples/s at 'highest' against this card's peaks (the
      card must be known; every share <= 100%).
15. The lowering selection, with ``GAR_TUNE_CACHE_FILE`` in a fresh
   temporary directory.
   ``dispatch='tune'`` at three shapes: the main path (1024 x 2352), the
      decimation path (256 x 3072) and the CLI's engine (2 x 8192); each
      engine's pin, ``contrast_s``, ``jitter_s``, each lowering's
      marginal ms a step, the tune's wall time and its graphs captured.
      Gates: where one lowering's ``graph_ms`` of the step is 2x or more
      the other's, the pin is the faster; the stream of each tuned engine
      (``process_device``, 20 blocks) equals bit for bit that of an
      engine built with ``dispatch=<pin>``, with the same K1 launches
      (none for 'xla'); a second engine of the same key hits the cache
      (0 graphs, its build time printed); a tune that refused ('auto')
      wrote no cache entry.
   Entry points: ``TimeMajorEngine(dispatch='tune')`` at the main shape
      (its pin, and K2 against its plain version at its step);
      ``Config(dispatch='tune')`` at 256 channels, equal bit for bit to
      the pinned config; the CLI's ``-dispatch tune`` on phase 14's
      5-minute stereo file, equal bit for bit to ``-dispatch <pin>``;
      ``ShardedEngineCore`` at world size 1 (``nccl``): its pin.
   ``set_conv_impl`` at the walk prestage's shape ([256, 2213] x [293,
      256]) with cuDNN's TF32 at its default (on): None and 'banded'
      launch K1, 'frames' and 'xla' none, each within 2e-5 of max|y| of
      K1's output ('xla' turns TF32 off), each lowering's graph_ms; the
      override None and TF32 as it was afterwards.
16. The examples (``go_audio_resampler_tpu_torch/examples/``): each
   ``main(device='cuda')``, its own asserts required, then the same
   example on the CPU: every array it returns within 2e-5 of max|y| of
   the CPU run's, lengths and counts equal; launches by kernel (K1 in
   ``basic``, ``device_serving``, ``ml_ingest_training`` and ``sharded``,
   K1 and K2 in ``hq_and_time_major``, none in ``variable_rate``); the
   ``hq_interp`` THD <= -120 dB; each example's wall time on the card.

Each path is driven with every launch count set to 0 just before it and
read just after; launches made to compare a kernel with its plain version
are not counted.  The phases run in the order 1, 2, 8 (kernels and
one-shot), 3, 4, 8 (engines and gate), 5, 6, 9, 10, 11, 12, 13, 14, 15,
16, 7.
Phase 14's records time each kernel at the shape its path really gave
it (its first launch there, recorded by a spy).  The last three
lines are the card, the kernels as JSON, and ``{"ok": true, "device":
{...}}``.  Every time printed is this card's, measured in this run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

#: Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
#: tensor cores, dense TF32 on the tensor cores, and HBM3 bandwidth.
#: Bounds below are stated against them.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: Tolerances: float32 kernel vs its float32 plain version (different
#: summation order), and float32 engine vs the float64 CPU engine.
KERNEL_TOL = 2e-5
ENGINE_TOL = 2e-5
THD_FLOOR_DB = -140.0          # QUALITY_tpu.json thd_44k_48k_high_db floor
#: The reduced matmul tiers: bf16 passes a product, R's limbs, and their
#: THD pins (tools/quality_tpu.py: thd_44k_48k_high_fast_tier_db and
#: thd_44k_48k_high_ingest_tier_db).
TIERS = ("high", "default")
TIER_PASSES = {"high": 3, "default": 1}
TIER_LIMBS = {"high": 2, "default": 1}
TIER_THD_DB = {"high": -110.0, "default": -65.0}
#: 'high' against float64: tests/test_precision_tier.py's bound, of max|y|.
HIGH_TOL = 3e-4

RATE_IN, RATE_OUT = 44100, 48000
STREAMS, SECONDS, BLOCK = 1024, 10, 2352
#: Decimation path: 48k -> 16k HIGH, 256 streams of 313 periods of 1536
#: input samples (10.016 s; the time-major engine takes whole periods).
DECIM_IN, DECIM_OUT = 48000, 16000
DECIM_STREAMS, DECIM_SAMPLES = 256, 313 * 1536
DECIM_CARRY = 1350                  # round_up(1349 taps - 1, 3)
#: One-shot phase: 64 streams of 2 s.
ONESHOT_STREAMS, ONESHOT_SECONDS = 64, 2
#: Walk phase: 44.1k -> 48.001k HIGH, the general streaming walk
#: (bench.py:501-522), 256 streams of 10 s at block 2048; THD floors of
#: its 1 kHz stream, default banks and hq_interp (tools/quality_tpu.py:
#: thd_stream_44k_48k001_high_db, thd_stream_44k_48k001_hq_interp_db).
WALK_OUT, WALK_STREAMS, WALK_BLOCK = 48001, 256, 2048
THD_WALK_DB, THD_WALK_HQ_DB = -85.0, -120.0
#: The hq_interp example's THD on the card (phase 16): the bound that its
#: CPU test holds both packages to (tests/test_torch_examples.py).
EXAMPLE_THD_HQ_DB = -150.0
#: The kernels each example launches on the card (phase 16).
EXAMPLE_KERNELS = {"basic": ("K1",), "device_serving": ("K1",),
                   "hq_and_time_major": ("K1", "K2"),
                   "ml_ingest_training": ("K1",), "sharded": ("K1",),
                   "variable_rate": ()}
#: dft_up and cubic phase: 256 streams of 2 s.
SMALL_STREAMS, SMALL_SECONDS = 256, 2
#: Strict antialias and banded composites.  Path A: 96 kHz -> 44.1 kHz
#: HIGH, the composite the API fuses (a 2x decimator, then 48k -> 44.1k
#: with the prefilter), 256 streams of 10 s; its floors are those of
#: thd_96k_48k_high_db and alias_rejection_96k_48k_db (QUALITY_tpu.json;
#: tools/quality_tpu.py:80-94), the nearest HIGH floors for a 96 kHz input.
COMP_IN, COMP_OUT, COMP_STREAMS = 96000, 44100, 256
THD_COMP_DB, ALIAS_DB = -130.0, 100.0
#: Path B: 48k -> 44.1k HIGH, the prefilter composed in, 1024 streams.
STRICT_STREAMS = 1024
#: Path C: 192 kHz -> 48 kHz HIGH (two 2x decimators, no head), 256
#: streams of 1067 periods of 1800 input samples (10.003 s).
C_STREAMS, C_SAMPLES = 256, 1067 * 1800
#: Path D: 48k -> 44.099k HIGH, the walk behind the prefilter, 256
#: streams of 2 s, held against its one-shot as the walk is (5e-6 of
#: max|y|).
D_OUT, D_STREAMS = 44099, 256
WALK_VS_ONESHOT = 5e-6


def require(ok, what="check failed") -> None:
    """Fail the run (also under ``python -O``, which strips asserts)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def ptxas_summary(log: str) -> list[str]:
    """Each kernel variant's registers and spills from a ``ptxas -v``
    report, one line a variant, named by its template arguments (K1, K2:
    <warpgroups, tier code>; K3: <warpgroups, k-steps a stage, tier code>;
    tier codes as ``precision.TIER_CODES``)."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"([a-z][a-z_]*_kernel)I((?:Li\d+E)+)", line)
            if m:
                args = ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
                name = f"{m.group(1)}<{args}>"
            else:
                name = line.split()[-1][:60]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = line.split(":", 1)[-1].strip()
            out.append(f"{name}: {regs}; {spill}")
            name, spill = "?", ""
    return out


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


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Mean device time of one call of ``fn`` in ms: ``reps`` calls
    captured in one CUDA graph and replayed ``iters`` times, so that the
    host's enqueue time is not counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


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
    r_t, ipx, wx, p2 = eng._band[:4]
    return r_t.to("cuda"), ipx, wx, p2


def banded_cost(rt, op, rows: int, data_elems: int) -> dict:
    """The work and bounds of ``rows`` windows times R_t [wx, p2]: flops
    on R's non-zeros (2*nnz*rows) and on the kernels' band-limited walk
    (every 80-column tile over its band's k-steps, one pass of three), the
    bytes the function must move (the ``data_elems`` samples its frames
    span and R's non-zeros read once, y written once), and its bounds on
    this card as float32 FMAs and as three TF32 tensor-core passes."""
    import torch
    from go_audio_resampler_tpu_torch.ops import banded
    wx, p2 = rt.shape
    nnz = int(torch.count_nonzero(rt).item())
    tiles = banded.tile_bands(op.bands.cpu())
    walk = int((tiles[:, 1] - tiles[:, 0]).sum()) * 8 * banded.TILE_N
    flops = 2 * nnz * rows
    bytes_ = 4 * (data_elems + nnz + rows * p2)
    t_bytes = bytes_ / PEAK_HBM_BYTES * 1e3
    f32 = max(flops / PEAK_F32_FLOPS * 1e3, t_bytes)
    tc = max(3 * flops / PEAK_TF32_FLOPS * 1e3, t_bytes)
    return {"flops_nnz": flops, "nnz_share": nnz / (wx * p2),
            "flops_band": 2 * walk * rows, "band_share": walk / (wx * p2),
            "bytes": bytes_,
            "bound_f32_fma_ms": f32,
            "bound_f32_fma_by": "bytes" if t_bytes >= f32 else "operations",
            "bound_ms": tc,
            "bound_by": "bytes" if t_bytes >= tc else "operations",
            "blocks": (-(-rows // banded.tile_rows(op.split))) * len(tiles)
            * op.split}


def time_banded(label: str, kernel, plain, libraries: dict,
                cost: dict) -> dict:
    """Times a K1/K2 shape (CUDA graphs), prints it and returns its
    fields for the kernels' JSON line."""
    ms = graph_ms(kernel)
    plain_ms = graph_ms(plain, reps=5, iters=5)
    lib = {name: graph_ms(fn, reps=5, iters=5)
           for name, fn in libraries.items()}
    print(f"  {label}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          + ", ".join(f"{k} {v:.5f} ms" for k, v in lib.items())
          + f" (TF32 off); bounds {cost['bound_f32_fma_ms']:.5f} ms as "
          f"float32 FMAs ({cost['bound_f32_fma_by']}), {cost['bound_ms']:.5f}"
          f" ms as 3xTF32 on the tensor cores ({cost['bound_by']}); work "
          f"{cost['flops_nnz']} flops on R's non-zeros "
          f"({cost['nnz_share']:.3f} of dense), {cost['flops_band']} flops "
          f"on the band-limited walk ({cost['band_share']:.3f} of dense; "
          f"x3 passes), {cost['bytes']} bytes; {cost['blocks']} blocks; "
          f"{cost['flops_nnz'] / (ms * 1e-3) / 1e12:.2f} TFLOP/s of useful "
          "work")
    return {"ms": ms, "plain_ms": plain_ms, **lib,
            "library_ms": min(lib.values()), **cost}


def kernel_phase(gen) -> dict:
    """K1 against its plain version, then timed at the main path's and the
    decimation path's shapes."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch import Quality
    from go_audio_resampler_tpu_torch.ops import banded, fused

    def check(name, s, n_frames, rt, ipx, wx, p2, extra=0):
        op = banded.prepare(rt, tier="highest")
        x = torch.randn((s, (n_frames - 1) * ipx + wx + extra),
                        generator=gen, device="cuda")
        y = fused.fused_resample(x, rt, ipx=ipx, wx=wx, p2=p2,
                                 n_frames=n_frames, op=op, tier="highest")
        ref = fused.fused_resample_reference(x, rt, ipx=ipx, wx=wx, p2=p2,
                                             n_frames=n_frames,
                                             tier="highest")
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        print(f"  K1 {name}: data {tuple(x.shape)}, R_t {tuple(rt.shape)}, "
              f"{n_frames} frames, ipx {ipx}, split {op.split}: "
              f"max |kernel - plain| = {err:.3g}")
        require(y.shape == (s, n_frames * p2) and math.isfinite(err),
                f"K1 {name}: shape {tuple(y.shape)}, error {err}")
        require(err <= KERNEL_TOL, f"K1 {name}: {err} > {KERNEL_TOL}")
        return x, op, err

    rt, ipx, wx, p2 = operator(Quality.HIGH)
    require((tuple(rt.shape), ipx) == ((343, 160), 147), (rt.shape, ipx))
    n_frames = BLOCK // ipx
    carry = -(-(wx - ipx) // ipx) * ipx
    # The main-path step: [carry ++ block] = [1024, 294 + 2352].
    x_main, op, err = check("main path", STREAMS, n_frames, rt, ipx, wx, p2,
                            extra=carry + BLOCK - ((n_frames - 1) * ipx + wx))
    require(tuple(x_main.shape) == (STREAMS, 2646), tuple(x_main.shape))
    errs = [err]
    errs.append(check("ragged", 5, 13, rt, ipx, wx, p2, extra=5)[2])
    # Rows that start off a 16-byte boundary take the 4-byte staging; the
    # bits equal those of the same data aligned.
    kw13 = dict(ipx=ipx, wx=wx, p2=p2, n_frames=13, op=op, tier="highest")
    x_odd = torch.randn(6 * 2112 + 3, generator=gen,
                        device="cuda")[3:].view(6, 2112)
    y_odd = fused.fused_resample(x_odd, rt, **kw13)
    err = (y_odd - fused.fused_resample_reference(
        x_odd, rt, ipx=ipx, wx=wx, p2=p2, n_frames=13,
        tier="highest")).abs().max().item()
    same = torch.equal(y_odd, fused.fused_resample(x_odd.clone(), rt, **kw13))
    print(f"  K1 unaligned rows: data {tuple(x_odd.shape)} at a 12-byte "
          f"offset: max |kernel - plain| = {err:.3g}; equal to the aligned "
          f"copy's bits: {same}")
    require(x_odd.data_ptr() % 16 and err <= KERNEL_TOL and same,
            f"K1 unaligned rows: error {err}, bits equal {same}")
    errs.append(err)
    rt2, ipx2, wx2, p22 = operator(Quality.HIGH, RATE_OUT, RATE_IN)
    require((tuple(rt2.shape), ipx2) == ((351, 147), 160), (rt2.shape, ipx2))
    errs.append(check("48k->44.1k", 37, 20, rt2, ipx2, wx2, p22)[2])
    rt3, ipx3, wx3, p23 = operator(Quality.VERY_HIGH)
    errs.append(check("superframed VERY_HIGH", 9, 11, rt3, ipx3, wx3,
                      p23)[2])
    rt4, ipx4, wx4, p24 = decim_operator()
    # The decimation path's step: [carry ++ block] = [256, 1350 + 3072].
    x_dec, op4, err = check("decimation path", DECIM_STREAMS, 2, rt4, ipx4,
                            wx4, p24, extra=DECIM_CARRY + ipx4 - wx4)
    require(tuple(x_dec.shape) == (DECIM_STREAMS, 4422) and op4.split == 8,
            f"decimation step {tuple(x_dec.shape)}, split {op4.split}")
    errs.append(err)

    # Offsets past 2^31 elements: row 1 of a [2, 1.2e9] input ends beyond
    # 2^31, and so does its output; the tail frames are checked.
    big_n = 1_200_000_000
    nfb = (big_n - wx) // ipx + 1
    xb = torch.empty((2, big_n), device="cuda").normal_(generator=gen)
    yb = fused.fused_resample(xb, rt, ipx=ipx, wx=wx, p2=p2, n_frames=nfb,
                              op=op, tier="highest")
    tail = 64
    f0 = nfb - tail
    ref = fused.fused_resample_reference(
        xb[1:, f0 * ipx:].contiguous(), rt, ipx=ipx, wx=wx, p2=p2,
        n_frames=tail, tier="highest")
    err = (yb[1:, f0 * p2:] - ref).abs().max().item()
    torch.cuda.synchronize()
    print(f"  K1 64-bit offsets: data (2, {big_n}), y {tuple(yb.shape)}: "
          f"max |kernel - plain| over the last {tail} frames = {err:.3g}")
    require(yb.numel() > 2 ** 31 and err <= KERNEL_TOL,
            f"K1 64-bit offsets: error {err}")
    errs.append(err)
    del xb, yb, ref
    torch.cuda.empty_cache()

    shapes = {}
    for shape, x, r_t, op_, (ip, w, p, nf) in (
            ("main", x_main, rt, op, (ipx, wx, p2, n_frames)),
            ("decimation", x_dec, rt4, op4, (ipx4, wx4, p24, 2))):
        kw = dict(ipx=ip, wx=w, p2=p, n_frames=nf, tier="highest")
        weight = r_t.t().contiguous()[:, None, :]             # [p2, 1, wx]
        lib_in = x[:, None, :(nf - 1) * ip + w].contiguous()
        frames = x.unfold(1, w, ip)[:, :nf]                   # [S, F, wx]
        lib = F.conv1d(lib_in, weight, stride=ip)             # [S, p2, F]
        got = fused.fused_resample(x, r_t, op=op_, **kw)
        lib_err = max((lib.transpose(1, 2).reshape(x.shape[0], -1)
                       - got).abs().max().item(),
                      (torch.matmul(frames, r_t).reshape(x.shape[0], -1)
                       - got).abs().max().item())
        require(lib_err <= KERNEL_TOL, f"K1 {shape}: library calls "
                f"disagree by {lib_err}")
        shapes[shape] = time_banded(
            f"K1 {shape} shape", lambda: fused.fused_resample(
                x, r_t, op=op_, **kw),
            lambda: fused.fused_resample_reference(x, r_t, **kw),
            {"library_conv1d_ms": lambda: F.conv1d(lib_in, weight,
                                                   stride=ip),
             "library_matmul_ms": lambda: torch.matmul(frames, r_t)},
            banded_cost(r_t, op_, x.shape[0] * nf,
                        x.shape[0] * ((nf - 1) * ip + w)))
    main = shapes["main"]
    return {"name": "fused_resample", "route": "cuda",
            "source": "go_audio_resampler_tpu_torch/ops/csrc/"
                      "fused_resample.cu",
            "replaces": "go_audio_resampler_tpu/ops/pallas_fused.py:210",
            "launches": None, "max_abs_err": max(errs), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": shapes}


def k2_phase(gen) -> dict:
    """K2 against its plain version (and K1), then timed at the
    time-major path's and the decimation path's shapes."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch import Quality
    from go_audio_resampler_tpu_torch.ops import banded, fused, tmajor

    def check(name, s, n_frames, rt, ipx, wx, p2, extra=0):
        r = rt.t().contiguous()
        op = banded.prepare(rt, tier="highest")
        xt = torch.randn(((n_frames - 1) * ipx + wx + extra, s),
                         generator=gen, device="cuda")
        y = tmajor.fused_resample_tmajor(xt, r, ipx=ipx, wx=wx, p2=p2,
                                         n_frames=n_frames, op=op,
                                         tier="highest")
        ref = tmajor.fused_resample_tmajor_reference(xt, r, ipx=ipx, wx=wx,
                                                     p2=p2, n_frames=n_frames,
                                                     tier="highest")
        k1 = fused.fused_resample(xt.t().contiguous(), rt, ipx=ipx, wx=wx,
                                  p2=p2, n_frames=n_frames, op=op,
                                  tier="highest")
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        same = bool(torch.equal(y, k1.t()))
        print(f"  K2 {name}: xT {tuple(xt.shape)}, R {tuple(r.shape)}, "
              f"{n_frames} frames, ipx {ipx}, split {op.split}: max |kernel "
              f"- plain| = {err:.3g}; equal to K1 bit for bit: {same}")
        require(y.shape == (n_frames * p2, s) and math.isfinite(err),
                f"K2 {name}: shape {tuple(y.shape)}, error {err}")
        require(err <= KERNEL_TOL, f"K2 {name}: {err} > {KERNEL_TOL}")
        require(same, f"K2 {name}: differs from K1 on the same data")
        return xt, op, err

    rt, ipx, wx, p2 = operator(Quality.HIGH)
    n_frames = BLOCK // ipx
    carry = -(-(wx - ipx) // ipx) * ipx
    # The time-major path's step: [carry ++ block] = [294 + 2352, 1024].
    xt_main, op, err = check("time-major path", STREAMS, n_frames, rt, ipx,
                             wx, p2, extra=carry + BLOCK
                             - ((n_frames - 1) * ipx + wx))
    require(tuple(xt_main.shape) == (2646, STREAMS), tuple(xt_main.shape))
    errs = [err]
    errs.append(check("ragged", 1000, 13, rt, ipx, wx, p2, extra=5)[2])
    errs.append(check("single frame", 3, 1, rt, ipx, wx, p2)[2])
    rt2, ipx2, wx2, p22 = operator(Quality.HIGH, RATE_OUT, RATE_IN)
    errs.append(check("48k->44.1k", 37, 20, rt2, ipx2, wx2, p22)[2])
    rt3, ipx3, wx3, p23 = operator(Quality.VERY_HIGH)
    errs.append(check("superframed VERY_HIGH", 129, 7, rt3, ipx3, wx3,
                      p23)[2])
    rt4, ipx4, wx4, p24 = decim_operator()
    # The decimation path's step: [carry ++ block] = [1350 + 3072, 256].
    xt_dec, op4, err = check("decimation path", DECIM_STREAMS, 2, rt4, ipx4,
                             wx4, p24, extra=DECIM_CARRY + ipx4 - wx4)
    require(tuple(xt_dec.shape) == (4422, DECIM_STREAMS),
            tuple(xt_dec.shape))
    errs.append(err)

    # Offsets past 2^31 elements: a [17e6, 128] input and its output.
    big_n = 17_000_000
    nfb = (big_n - wx) // ipx + 1
    r = rt.t().contiguous()
    xb = torch.empty((big_n, 128), device="cuda").normal_(generator=gen)
    yb = tmajor.fused_resample_tmajor(xb, r, ipx=ipx, wx=wx, p2=p2,
                                      n_frames=nfb, op=op, tier="highest")
    tail = 64
    f0 = nfb - tail
    ref = tmajor.fused_resample_tmajor_reference(
        xb[f0 * ipx:].contiguous(), r, ipx=ipx, wx=wx, p2=p2, n_frames=tail,
        tier="highest")
    err = (yb[f0 * p2:] - ref).abs().max().item()
    torch.cuda.synchronize()
    print(f"  K2 64-bit offsets: xT ({big_n}, 128), yT {tuple(yb.shape)}: "
          f"max |kernel - plain| over the last {tail} frames = {err:.3g}")
    require(xb.numel() > 2 ** 31 and yb.numel() > 2 ** 31
            and err <= KERNEL_TOL, f"K2 64-bit offsets: error {err}")
    errs.append(err)
    del xb, yb, ref
    torch.cuda.empty_cache()

    shapes = {}
    for shape, xt, r_t, op_, (ip, w, p, nf) in (
            ("main", xt_main, rt, op, (ipx, wx, p2, n_frames)),
            ("decimation", xt_dec, rt4, op4, (ipx4, wx4, p24, 2))):
        kw = dict(ipx=ip, wx=w, p2=p, n_frames=nf, tier="highest")
        s = xt.shape[1]
        r = r_t.t().contiguous()
        # Library yardsticks: conv1d on the stream-major copy (the
        # transpose is set-up, not timed), and one batched matmul on the
        # unfold view along time.
        weight = r[:, None, :]                                # [p2, 1, wx]
        lib_in = xt.t().contiguous()[:, None, :]
        frames_t = xt[:(nf - 1) * ip + w].unfold(0, w, ip).transpose(1, 2)
        got = tmajor.fused_resample_tmajor(xt, r, op=op_, **kw)
        lib = F.conv1d(lib_in, weight, stride=ip)             # [S, p2, F]
        lib_err = max((lib.permute(2, 1, 0).reshape(nf * p, s)
                       - got).abs().max().item(),
                      (torch.matmul(r, frames_t).reshape(nf * p, s)
                       - got).abs().max().item())
        require(lib_err <= KERNEL_TOL, f"K2 {shape}: library calls "
                f"disagree by {lib_err}")
        shapes[shape] = time_banded(
            f"K2 {shape} shape", lambda: tmajor.fused_resample_tmajor(
                xt, r, op=op_, **kw),
            lambda: tmajor.fused_resample_tmajor_reference(xt, r, **kw),
            {"library_conv1d_ms": lambda: F.conv1d(lib_in, weight,
                                                   stride=ip),
             "library_matmul_ms": lambda: torch.matmul(r, frames_t)},
            banded_cost(r_t, op_, s * nf, s * ((nf - 1) * ip + w)))
    main = shapes["main"]
    return {"name": "fused_resample_tmajor", "route": "cuda",
            "source": "go_audio_resampler_tpu_torch/ops/csrc/"
                      "fused_resample_tmajor.cu",
            "replaces": "go_audio_resampler_tpu/ops/pallas_fused.py:396",
            "launches": None, "max_abs_err": max(errs), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": shapes}


#: The one-shot K3 shapes: 64 streams of 2 s at 44.1 kHz.
K3_SHAPES = {"general": (RATE_IN, 48001, "HIGH"),
             "cubic": (RATE_IN, RATE_OUT, "QUICK")}


def k3_operands(shape: str) -> tuple:
    """(starts, M [n_tiles, w, tile] float32, bands, warpgroups) of a
    one-shot K3 shape (``K3_SHAPES``) on the card, as ``oneshot`` uploads
    them: 44.1 kHz -> 48.001 kHz HIGH (general) or 44.1 kHz -> 48 kHz
    QUICK (cubic).  ``bands`` and ``warpgroups`` are None where the port's
    ``_upload`` gives no band table and block width."""
    import importlib
    import torch
    from go_audio_resampler_tpu_torch import Quality, plan_engine
    osm = importlib.import_module("go_audio_resampler_tpu_torch.engine.oneshot")
    rate_in, rate_out, q = K3_SHAPES[shape]
    plan = plan_engine(rate_in, rate_out, Quality[q])
    count = plan.lengths.canonical(ONESHOT_SECONDS * rate_in)
    build = (osm._cubic_matrices if plan.kind == "cubic"
             else osm._general_matrices)
    up = osm._upload(build(plan, count), torch.float32, "cuda")
    return tuple(up) + (None,) * (4 - len(up))


def k3_cost(x, m, starts, bands, warpgroups: int) -> dict:
    """The work and bounds of K3 on x [S, n] and M [n_tiles, w, tile]:
    flops on M's non-zeros (2*S*nnz, three TF32 passes on the tensor
    cores), the bytes the function must move (M's non-zeros, or all of M
    for the dense figure, the samples of x its windows span, starts, and
    y once), the bounds on this card, and the shares of the dense product
    that the kernel's bands hold (each 8 columns' and each warpgroup's 64
    columns' k-steps)."""
    import torch
    from go_audio_resampler_tpu_torch.ops import general
    s, n = x.shape
    n_tiles, w_band, tile = m.shape
    nnz = int(torch.count_nonzero(m).item())
    span, reach = 0, 0                      # union of the windows in [0, n)
    for a in sorted(starts.cpu().tolist()):
        lo, hi = max(a, reach, 0), min(a + w_band, n)
        span += max(0, hi - lo)
        reach = max(reach, hi)
    flops = 2 * s * nnz
    signal = 4 * (s * span + s * n_tiles * tile) + starts.numel() \
        * starts.element_size()
    bytes_nnz, bytes_dense = 4 * nnz + signal, 4 * m.numel() + signal
    t_tc = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_nnz = bytes_nnz / PEAK_HBM_BYTES * 1e3
    t_dense = bytes_dense / PEAK_HBM_BYTES * 1e3
    ks = -(-w_band // 8)
    b = (bands if bands is not None else general.band_table(m)).cpu()
    b = b.clamp(max=ks).view(n_tiles, -1, 2)
    per8 = int((b[..., 1] - b[..., 0]).clamp(min=0).sum()) * 64
    per = general.WARPGROUP_P // general.BAND_N
    groups = -(-b.shape[1] // per)
    g = torch.zeros((n_tiles, groups * per, 2), dtype=torch.int64)
    g[:, :b.shape[1]] = b
    g = g.view(n_tiles, groups, per, 2)
    live = g[..., 1] > g[..., 0]
    lo = torch.where(live, g[..., 0], 1 << 30).min(dim=2).values
    hi = torch.where(live, g[..., 1], 0).max(dim=2).values
    walk = int(torch.where(hi > 0, hi - lo, 0).sum()) * 8 * general.WARPGROUP_P
    dense = n_tiles * ks * 8 * tile
    return {"flops_nnz": flops, "nnz_share": nnz / m.numel(),
            "band_share_8_columns": per8 / dense,
            "band_share_warpgroup": walk / dense,
            "own_share_of_pairs": general.own_share(b),
            "m_bytes_in_band": 4 * per8, "x_span": span,
            "bytes": bytes_nnz, "bytes_dense": bytes_dense,
            "bound_ms": max(t_tc, t_nnz),
            "bound_by": "bytes" if t_nnz >= t_tc else "operations",
            "bound_dense_ms": max(t_tc, t_dense),
            "bound_f32_fma_ms": max(flops / PEAK_F32_FLOPS * 1e3, t_nnz),
            "blocks": n_tiles * -(-s // general.TILE_S)
            * -(-tile // (warpgroups * general.WARPGROUP_P))}


def k3_at(label: str, x, m, starts, bands, wgs) -> dict:
    """K3 timed at one shape (x [S, n], M [n_tiles, w, tile]) beside its
    plain version and ``torch.bmm`` over the gathered frames, with its
    bounds; the record for the kernels' line."""
    import torch
    from go_audio_resampler_tpu_torch.ops import general

    n_tiles, w_band, tile = m.shape
    kw = dict(w_band=w_band, tile=tile, tier="highest")
    cost = k3_cost(x, m, starts, bands, wgs)
    ms = graph_ms(lambda: general.general_resample(
        x, m, starts, bands=bands, warpgroups=wgs, **kw))
    plain_ms = graph_ms(lambda: general.general_resample_reference(
        x, m, starts, **kw), reps=5, iters=5)
    # No single PyTorch call computes K3; the nearest is one batched
    # product over frames already gathered (the gather not timed).
    idx = starts[:, None] + torch.arange(w_band, device="cuda")[None, :]
    frames = x[:, idx].permute(1, 0, 2).contiguous()      # [T, S, W]
    bmm = torch.bmm(frames, m).permute(1, 0, 2).reshape(x.shape[0], -1)
    bmm_err = (bmm - general.general_resample(
        x, m, starts, bands=bands, warpgroups=wgs, **kw)).abs().max().item()
    require(bmm_err <= KERNEL_TOL, f"K3 {label}: torch.bmm disagrees "
            f"by {bmm_err}")
    bmm_ms = graph_ms(lambda: torch.bmm(frames, m), reps=5, iters=5)
    print(f"  K3 {label} shape: kernel {ms:.5f} ms, plain "
          f"(gather+einsum) {plain_ms:.5f} ms, no single library call "
          f"(nearest: torch.bmm over the gathered frames, gather not "
          f"timed, {bmm_ms:.5f} ms); bound {cost['bound_ms']:.5f} ms, "
          f"{cost['bound_by']} ({cost['bytes']} bytes with M's "
          f"{cost['nnz_share']:.4f} non-zeros, 3x{cost['flops_nnz']} "
          f"TF32 flops), dense-M bound {cost['bound_dense_ms']:.5f} ms "
          f"({cost['bytes_dense']} bytes); kernel at "
          f"{cost['bound_ms'] / ms:.3f} of its bound; bands hold "
          f"{cost['band_share_8_columns']:.4f} (8 columns) and "
          f"{cost['band_share_warpgroup']:.4f} (64 columns) of the "
          f"dense product, a 64-column group's band "
          f"{cost['own_share_of_pairs']:.4f} of its 128-column pair's; "
          f"{cost['blocks']} blocks of {wgs} warpgroup(s)")
    return {"ms": ms, "plain_ms": plain_ms, "bmm_gathered_ms": bmm_ms,
            **cost}


def k3_phase(gen) -> dict:
    """K3 against its plain version, then timed at the one-shot general
    and cubic shapes."""
    import torch
    from go_audio_resampler_tpu_torch.ops import general

    def check(name, x, m, starts, w_band, tile, bands, warpgroups=2):
        y = general.general_resample(x, m, starts, w_band=w_band, tile=tile,
                                     bands=bands, warpgroups=warpgroups,
                                     tier="highest")
        ref = general.general_resample_reference(x, m, starts,
                                                 w_band=w_band, tile=tile,
                                                 tier="highest")
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        print(f"  K3 {name}: x {tuple(x.shape)}, M {tuple(m.shape)}, "
              f"w_band {w_band}, tile {tile}, starts {starts.dtype}, "
              f"{warpgroups} warpgroup(s) a block: max |kernel - plain| = "
              f"{err:.3g}")
        require(y.shape == (x.shape[0], m.shape[0] * tile)
                and math.isfinite(err), f"K3 {name}: shape {tuple(y.shape)}")
        require(err <= KERNEL_TOL, f"K3 {name}: {err} > {KERNEL_TOL}")
        return err

    def random_case(s, n_tiles, w_band, tile, n, band=None):
        x = torch.randn((s, n), generator=gen, device="cuda")
        m = torch.randn((n_tiles, w_band, tile), generator=gen,
                        device="cuda") / math.sqrt(w_band)
        if band is not None:                # taps lo + p//2 + [0, width)
            w = (torch.arange(w_band, device="cuda")[:, None] - band[0]
                 - torch.arange(tile, device="cuda")[None, :] // 2)
            m = m * ((w >= 0) & (w < band[1]))
        starts = torch.sort(torch.randint(-3, n - w_band // 2, (n_tiles,),
                                          generator=gen, device="cuda")).values
        return x, m, starts, w_band, tile, general.band_table(m).cuda()

    errs, shapes, inputs = [], {}, {}
    for shape in K3_SHAPES:
        starts, m, bands, wgs = k3_operands(shape)
        n_tiles, w_band, tile = m.shape
        x = 0.5 * torch.randn((ONESHOT_STREAMS, int(starts[-1].item())
                               + w_band), generator=gen, device="cuda")
        inputs[shape] = (x, m, starts, bands, wgs)
        for w in (wgs, 3 - wgs):            # its block width, and the other
            errs.append(check(f"one-shot {shape} shape", x, m, starts,
                              w_band, tile, bands, w))
        errs.append(check(f"one-shot {shape} shape, 65 streams",
                          torch.cat([x, x[:1]]), m, starts.int(), w_band,
                          tile, bands, wgs))
    for w in (1, 2):
        errs.append(check("ragged streams and columns",
                          *random_case(65, 7, 17, 200, 500), w))
        errs.append(check("one tile, one stream",
                          *random_case(1, 1, 300, 256, 400), w))
        errs.append(check("narrow bands, several column blocks",
                          *random_case(66, 9, 300, 512, 4000, (40, 12)), w))
        errs.append(check("4-byte copies (tile 30, rows of 601)",
                          *random_case(9, 4, 37, 30, 601), w))
    # Offsets past 2^31 elements: windows near the end of row 1 of a
    # [2, 1.2e9] input.
    big_n = 1_200_000_000
    xb = torch.empty((2, big_n), device="cuda").normal_(generator=gen)
    mb = torch.randn((4, 300, 256), generator=gen, device="cuda") / 17.0
    sb = torch.tensor([big_n - 2000, big_n - 1500, big_n - 700, big_n - 250],
                      device="cuda")
    yb = general.general_resample(xb, mb, sb, w_band=300, tile=256,
                                  bands=general.band_table(mb).cuda(),
                                  warpgroups=1, tier="highest")
    lo = big_n - 2000
    ref = general.general_resample_reference(xb[1:, lo:].contiguous(), mb,
                                             sb - lo, w_band=300, tile=256,
                                             tier="highest")
    err = (yb[1:] - ref).abs().max().item()
    print(f"  K3 64-bit offsets: x (2, {big_n}), windows at the end of row "
          f"1: max |kernel - plain| = {err:.3g}")
    require(err <= KERNEL_TOL, f"K3 64-bit offsets: error {err}")
    errs.append(err)
    del xb, yb, ref
    torch.cuda.empty_cache()

    for shape, (x, m, starts, bands, wgs) in inputs.items():
        shapes[shape] = k3_at(f"one-shot {shape}", x, m, starts, bands, wgs)
    main = shapes["general"]
    return {"name": "general_resample", "route": "cuda",
            "source": "go_audio_resampler_tpu_torch/ops/csrc/"
                      "general_resample.cu",
            "replaces": "go_audio_resampler_tpu/ops/pallas_fused.py:502",
            "launches": None, "max_abs_err": max(errs), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shapes": shapes}


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
    ipx, p2 = eng._period
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
                                 eng._drop)
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


def timed_run(eng, data, chunks) -> tuple[list, dict]:
    """One run of a streaming engine over ``chunks`` (``data(a, b)`` is
    one), then its flush: the outputs, and the run's wall time (s), the
    host time of each ``process_device`` call (ms), the device span
    between events recorded before the first call and after the flush
    (ms), and the segments (``cudaMalloc`` calls) PyTorch's caching
    allocator added during the run."""
    import torch
    segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    steps, outs = [], []
    t0 = time.perf_counter()
    start.record()
    for a, b in chunks:
        t = time.perf_counter()
        outs.append(eng.process_device(data(a, b)))
        steps.append(time.perf_counter() - t)
    outs.append(eng.flush_device())
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return outs, {
        "wall": wall, "steps_ms": np.array(steps) * 1e3,
        "device_ms": start.elapsed_time(end),
        "segments": torch.cuda.memory_stats().get("segment.all.allocated", 0)
        - segments}


def run_stats(st: dict) -> str:
    """:func:`timed_run`'s record of one run, as printed."""
    steps = st["steps_ms"]
    slow = steps[steps > 0.5]
    return (f"host time per step: median {np.median(steps):.5f} ms, max "
            f"{steps.max():.5f} ms, {slow.size} steps over 0.5 ms "
            f"({slow.sum():.3f} ms in all); device span {st['device_ms']:.3f}"
            f" ms; {st['segments']} new allocator segments")


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
                                 eng._band.p2, block, eng._drop)
    counts, ys = [], []
    for label, e, data, dim in (
            ("EngineCore (K1)", eng, lambda a, b: x[:, a:b], 1),
            ("TimeMajorEngine (K2)", tm, lambda a, b: xt[a:b], 0)):
        # Each step's output is 1 MiB, which PyTorch's allocator takes
        # from its pool of small blocks, two to a new 2 MiB segment: the
        # cold run, from an emptied cache, grows that pool (79
        # cudaMalloc calls); the warm run, from the reset engine with the
        # cold run's outputs freed, finds the blocks cached, as a
        # long-running process does.
        outs = None
        torch.cuda.empty_cache()
        for run in ("cold", "warm"):
            outs = None
            e.reset()
            torch.cuda.synchronize()
            reset_launches()
            outs, st = timed_run(e, data, chunks)
            counts.append(launch_counts())
            print(f"  decimation path, {label}, {run} run: {DECIM_STREAMS} "
                  f"streams x {n} samples in {st['wall']:.4f} s = "
                  f"{DECIM_STREAMS * n / st['wall'] / 1e6:.1f} Msamples/s "
                  f"in, {counts[-1][dim == 0]} launches, {len(chunks)} "
                  f"chunks on {card}")
            print(f"  decimation path, {label}, {run} run: {run_stats(st)}")
        ys.append(torch.cat(outs, dim=dim))
    y, yt = ys
    require(tuple(y.shape) == (DECIM_STREAMS, canonical)
            and tuple(yt.shape) == (canonical, DECIM_STREAMS),
            f"decimation outputs {tuple(y.shape)}, {tuple(yt.shape)}, "
            f"canonical {canonical}")
    require(counts == [(expected, 0, 0)] * 2 + [(0, expected, 0)] * 2,
            f"decimation launches {counts}, expected {expected} a run")
    ref = EngineCore(plan, batch=4, block=2048, dtype=torch.float64,
                     device="cpu")
    x4 = x[:4].cpu().double().numpy()
    want = np.concatenate([ref.process(x4), ref.flush()], axis=1)
    err = float(np.abs(y[:4].cpu().double().numpy() - want).max())
    err_t = float(np.abs(yt[:, :4].t().cpu().double().numpy() - want).max())
    vs_stream = (yt.t() - y).abs().max().item()
    print(f"  decimation path: length {canonical} == canonical; max |cuda f32 "
          f"- cpu f64| over 4 streams = {err:.3g} (stream-major), "
          f"{err_t:.3g} (time-major); max |time-major - stream-major| = "
          f"{vs_stream:.3g}")
    require(max(err, err_t, vs_stream) <= ENGINE_TOL,
            f"decimation errors {err}, {err_t}, {vs_stream}")
    return counts[1][0], counts[3][1]


def oneshot_phase(gen, card: str) -> tuple[int, dict, tuple]:
    """64 streams x 2 s through ``oneshot`` for five topologies; returns
    the K1 launches, the K3 launches of each K3 shape, and the general
    topology's input and output (the walk phase streams the same input)."""
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
    k1_total, k3_by_shape, general = 0, {}, None
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
        aux = osm._oneshot_aux(plan, n, torch.float32, torch.device("cuda"),
                               tier="highest")
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
        k1_total += k1
        if want_k3:
            k3_by_shape[name.split("(")[1].split(",")[0]] = k3
        if name.startswith("44.1k->48.001k"):
            general = (x, y)
        want = oneshot(plan, x[:4].cpu().double().numpy(), device="cpu")
        err = float(np.abs(y[:4].cpu().double().numpy()
                           - want.numpy()).max())
        # The device part alone, with the operators already uploaded: the
        # kernel's device time and every kernel's from torch.profiler, and
        # the span of the call on CUDA events (its host work included).
        def apply():
            return osm._oneshot_apply(plan, x, aux, tier="highest")

        span_ms = cuda_ms(apply, 10, warmup=1)
        kname = "general_resample_kernel" if want_k3 else \
            "fused_resample_kernel"
        # torch.profiler now and then returns a trace without the card's
        # kernels: such a trace is taken again, up to three times in all.
        for traces in range(1, 4):
            kernels = device_kernels(apply, 5)
            kernel_ms = sum(ms for key, ms, _ in kernels if kname in key)
            if kernel_ms > 0:
                break
        require(kernel_ms > 0, f"{name}: no {kname} in {traces} "
                "torch.profiler traces")
        busy_ms = sum(ms for _, ms, _ in kernels)
        mbytes = sum(a.nbytes for a in host) / 1e6
        print(f"  one-shot {name}: [{ONESHOT_STREAMS}, {n}] -> "
              f"{tuple(y.shape)} == canonical; launches K1 {k1}, K3 {k3}; "
              f"max |cuda f32 - cpu f64| over 4 streams = {err:.3g}; host "
              f"design {t1 - t0:.3f} s ({mbytes:.1f} MB of float64 "
              f"operators), upload {t2 - t1:.4f} s, entry point "
              f"{wall:.4f} s on {card}")
        print(f"  one-shot {name}: device {kname} {kernel_ms:.5f} ms, all "
              f"kernels {busy_ms:.5f} ms (torch.profiler, trace {traces} of "
              f"at most 3); _oneshot_apply span {span_ms:.5f} ms (CUDA "
              "events)")
        for key, ms, count in kernels:
            print(f"  one-shot {name}: {ms:.5f} ms, {count:g} per call: "
                  f"{key[:80]}")
        require(err <= ENGINE_TOL, f"{name}: {err} > {ENGINE_TOL}")
    return k1_total, k3_by_shape, general


# -- the general walk, dft_up and cubic --------------------------------------


def walk_launches(plan, n: int, block: int) -> int:
    """K1 launches of the general walk fed ``n`` samples through
    ``process``, then flushed: one a block step, the flush's tail blocks
    and its extra zero blocks (fed while the core has not reached the
    canonical count) included."""
    lm = plan.lengths
    rem = n % block
    fed = n - rem + -(-(rem + lm.flush_pad(n)) // block) * block
    while lm.core_emitted(fed) < lm.canonical(n):
        fed += block
    return fed // block


def host_run(eng, x_np, rng, block: int) -> tuple[np.ndarray, float, int]:
    """``x_np`` through ``eng.process`` in random chunks of 1 to 3 blocks,
    then ``flush``: the output, the wall time (s; the outputs' final
    concatenation not included) and the chunks."""
    n = x_np.shape[1]
    outs, at, chunks = [], 0, 0
    t0 = time.perf_counter()
    while at < n:
        w = int(rng.integers(1, 3 * block + 1))
        outs.append(eng.process(x_np[:, at:at + w]))
        at += w
        chunks += 1
    outs.append(eng.flush())
    wall = time.perf_counter() - t0
    return np.concatenate(outs, axis=1), wall, chunks


def walk_prestage_kernel(eng, x) -> dict:
    """K1 at the walk's prestage shape (``_conv_banded`` with the engine's
    operator) against its plain version, timed beside it and ``F.conv1d``
    (stride 1, F = 2), with its bounds; and under ``force_xla``: no
    launch, the plain version's bits."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch.ops import convolve, fused, precision

    band = eng._pre_band(WALK_BLOCK)
    coeffs = eng.pre_coeffs
    t1 = coeffs.shape[1]
    xext = x[:, :t1 - 1 + WALK_BLOCK].contiguous()
    s = xext.shape[0]
    wx, p2 = band.r_t.shape
    nf = WALK_BLOCK // band.p
    require((band.p, wx, p2, nf) == (128, 127 + t1, 256, 16),
            f"walk prestage band: period {band.p}, R_t {(wx, p2)}")
    kw = dict(ipx=band.p, wx=wx, p2=p2, n_frames=nf, tier="highest")
    weight = coeffs[:, None, :].contiguous()              # [2, 1, T1]
    lib_in = xext[:, None, :]

    def kernel():
        return convolve._conv_banded(xext, coeffs, 1, interleaved=True,
                                     band=band, tier="highest")

    def plain():
        return fused.fused_resample_reference(xext, band.r_t, **kw)

    reset_launches()
    y = kernel()
    launched = launch_counts()
    ref = plain()
    lib = F.conv1d(lib_in, weight).transpose(1, 2).reshape(s, -1)
    reset_launches()
    with precision.force_xla():
        forced = kernel()
    torch.cuda.synchronize()
    forced_launches = launch_counts()
    err = (y - ref).abs().max().item()
    lib_err = (lib - y).abs().max().item()
    same = torch.equal(forced, ref)
    print(f"  K1 walk prestage: data {tuple(xext.shape)}, R_t {(wx, p2)}, "
          f"{nf} frames, ipx {band.p}, split {band.op.split}: max |kernel - "
          f"plain| = {err:.3g}, max |kernel - F.conv1d| = {lib_err:.3g}; "
          f"under force_xla {forced_launches} launches (K1, K2, K3), equal "
          f"to the plain version's bits: {same}")
    require(launched == (1, 0, 0) and tuple(y.shape) == (s, 2 * WALK_BLOCK),
            f"K1 walk prestage: launches {launched}, {tuple(y.shape)}")
    require(err <= KERNEL_TOL and lib_err <= KERNEL_TOL,
            f"K1 walk prestage: {err}, library {lib_err}")
    require(forced_launches == (0, 0, 0) and same,
            f"walk prestage under force_xla: {forced_launches}, {same}")
    timed = time_banded(
        "K1 walk-prestage shape", kernel, plain,
        {"library_conv1d_ms": lambda: F.conv1d(lib_in, weight)},
        banded_cost(band.r_t, band.op, s * nf, s * xext.shape[1]))
    return {**timed, "max_abs_err": err}


def walk_step_times(eng, x, card: str, profile: bool, steps: int = 40):
    """Warm steps of the walk on the card (``_step`` on device blocks, no
    download): host enqueue and device span per step; with ``profile``,
    each kernel's device time from ``torch.profiler``, K1 apart from the
    emit's."""
    import torch
    blocks = [x[:, i * WALK_BLOCK:(i + 1) * WALK_BLOCK]
              for i in range(steps)]
    state = eng._init_state()

    def run():
        nonlocal state
        for xb in blocks:
            state, _, _ = eng._step(state, xb)

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
    print(f"  walk step: {steps} warm steps of {x.shape[0]} streams x "
          f"{WALK_BLOCK}: host enqueue {(t1 - t0) / steps * 1e3:.5f} ms/step,"
          f" wall {wall:.5f} ms/step, device span {device:.5f} ms/step on "
          f"{card}")
    if not profile:
        return
    kernels = device_kernels(run, 1)
    k1 = sum(ms for name, ms, _ in kernels if "fused_resample_kernel" in name)
    busy = sum(ms for _, ms, _ in kernels)
    count = sum(c for _, _, c in kernels)
    print(f"  profile, walk step: K1 {k1 / steps:.5f} ms/step, the emit and "
          f"the rest {(busy - k1) / steps:.5f} ms/step, kernels busy "
          f"{busy / steps:.5f} ms/step in {count / steps:g} launches under "
          f"the profiler (device idle share "
          f"{max(0.0, 1 - busy / steps / wall):.3f}) on {card}")
    for name, ms, count in kernels:
        print(f"  profile, walk step: {ms / steps:.5f} ms/step, "
              f"{count / steps:g} per step: {name[:90]}")


def walk_path(gen, card: str, general, profile: bool) -> dict:
    """44.1k -> 48.001k HIGH, the general streaming walk: 256 streams x
    10 s through ``EngineCore.process`` in random chunks, then ``flush``;
    returns K1's launches and its record at the walk's prestage shape."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.engine import stages
    from go_audio_resampler_tpu_torch.ops import precision
    from go_audio_resampler_tpu_torch.utils import metrics, signals

    plan = plan_engine(RATE_IN, WALK_OUT, Quality.HIGH)
    eng = EngineCore(plan, batch=WALK_STREAMS, block=WALK_BLOCK)
    require(plan.kind == "two_stage" and not plan.is_rational_exact
            and eng.block == WALK_BLOCK and eng.device_chunk_multiple is None,
            f"walk plan {plan.kind}, block {eng.block}")
    n = RATE_IN * SECONDS
    x = 0.5 * torch.randn((WALK_STREAMS, n), generator=gen, device="cuda")
    x[0] = torch.as_tensor(signals.sine(n, 1000.0, RATE_IN),
                           dtype=torch.float32, device="cuda")
    x_np = x.cpu().numpy()
    # Warm steps first (also the run's warm-up: the emit's first launches
    # load their kernels and the matmul library).
    walk_step_times(eng, x, card, profile)
    rng = np.random.default_rng(7)
    canonical = plan.lengths.canonical(n)
    expected = walk_launches(plan, n, eng.block)
    reset_launches()
    y, wall, chunks = host_run(eng, x_np, rng, eng.block)
    launches = launch_counts()
    require(y.shape == (WALK_STREAMS, canonical),
            f"walk output {y.shape}, canonical {canonical}")
    require(launches == (expected, 0, 0),
            f"walk launches {launches}, expected ({expected}, 0, 0)")
    require(bool(np.isfinite(y).all()), "walk: non-finite output")
    ref = EngineCore(plan, batch=4, block=WALK_BLOCK, dtype=torch.float64,
                     device="cpu")
    want = np.concatenate([ref.process(x_np[:4].astype(np.float64)),
                           ref.flush()], axis=1)
    err = float(np.abs(y[:4] - want).max())
    thd = metrics.thd(y[0].astype(np.float64), WALK_OUT, 1000.0, 16384)
    hq = EngineCore(plan_engine(RATE_IN, WALK_OUT, Quality.HIGH,
                                hq_interp=True), batch=1, block=WALK_BLOCK)
    y_hq = host_run(hq, x_np[:1], rng, hq.block)[0]
    thd_hq = metrics.thd(y_hq[0].astype(np.float64), WALK_OUT, 1000.0, 16384)
    print(f"  walk: {WALK_STREAMS} streams x {n} samples through process() "
          f"in {chunks} random chunks in {wall:.4f} s = "
          f"{WALK_STREAMS * n / wall / 1e6:.1f} Msamples/s in, {expected} "
          f"steps ({wall / expected * 1e3:.4f} ms each, host and transfers "
          f"included), launches (K1, K2, K3) {launches}, poly_cap "
          f"{eng.poly_cap}, history {eng.hist_size} on {card}")
    print(f"  walk: length {y.shape[1]} == canonical {canonical}; max |cuda "
          f"f32 - cpu f64| over 4 streams = {err:.3g}; THD of the 1 kHz "
          f"stream = {thd:.2f} dB (floor {THD_WALK_DB}), with hq_interp "
          f"{thd_hq:.2f} dB (floor {THD_WALK_HQ_DB})")
    require(err <= ENGINE_TOL, f"walk vs float64: {err} > {ENGINE_TOL}")
    require(thd <= THD_WALK_DB, f"walk THD {thd} dB > {THD_WALK_DB} dB")
    require(thd_hq <= THD_WALK_HQ_DB,
            f"walk hq_interp THD {thd_hq} dB > {THD_WALK_HQ_DB} dB")
    del y, want

    # The one-shot phase's general input (its K3 output) through the walk.
    xg, yg = general
    w = EngineCore(plan, batch=xg.shape[0], block=WALK_BLOCK)
    ys = host_run(w, xg.cpu().numpy(), rng, w.block)[0]
    vs_oneshot = float(np.abs(ys - yg.cpu().numpy()).max())
    print(f"  walk vs one-shot (K3) of the same [{xg.shape[0]}, "
          f"{xg.shape[1]}] input: lengths {ys.shape[1]} and {yg.shape[1]}, "
          f"max |walk - one-shot| = {vs_oneshot:.3g}")
    require(ys.shape == tuple(yg.shape) and vs_oneshot <= ENGINE_TOL,
            f"walk vs one-shot: {ys.shape}, {tuple(yg.shape)}, {vs_oneshot}")

    # One block's state: the banded emit against the gather emit.
    e2 = EngineCore(plan, batch=WALK_STREAMS, block=WALK_BLOCK)
    e2.process(x_np[:, :3 * WALK_BLOCK])
    pre, poly = e2.state
    _, u = stages.prestage_process(
        e2.pre_coeffs, pre, x[:, 3 * WALK_BLOCK:4 * WALK_BLOCK],
        plan.factor, "highest", band=e2._pre_band(WALK_BLOCK))
    hl, m = poly.hist_len, u.shape[1]
    hist = torch.cat([poly.hist[:, :hl], u, poly.hist[:, hl + m:]], dim=1)
    args = (e2.banks, hist, hl + m, poly.at_hi, poly.at_lo, plan.num_phases,
            plan.poly_taps, plan.step_hi, plan.step_lo, e2.poly_cap)
    banded_y = stages.poly_emit(*args)
    real = stages._banded_emit_on
    stages._banded_emit_on = lambda h: False
    try:
        gather_y = stages.poly_emit(*args)
    finally:
        stages._banded_emit_on = real
    emit_err = (banded_y[0] - gather_y[0]).abs().max().item()
    print(f"  walk emit on one block's state: {banded_y[2]} outputs of "
          f"{e2.poly_cap}; max |banded tiles - gather| = {emit_err:.3g}")
    require(banded_y[2:] == gather_y[2:] and banded_y[2] > 0
            and torch.equal(banded_y[1], gather_y[1])
            and emit_err <= KERNEL_TOL,
            f"walk emit lowerings: counts {banded_y[2:]} and "
            f"{gather_y[2:]}, error {emit_err}")

    # The gate: under force_xla the prestage launches nothing.
    xs = x_np[:64, :20 * WALK_BLOCK]
    runs = {}
    for mode in ("kernel", "force_xla"):
        e = EngineCore(plan, batch=64, block=WALK_BLOCK)
        reset_launches()
        with (precision.force_xla() if mode == "force_xla"
              else contextlib.nullcontext()):
            yy = np.concatenate([e.process(xs), e.flush()], axis=1)
        runs[mode] = (yy, launch_counts())
    gate_err = float(np.abs(runs["kernel"][0] - runs["force_xla"][0]).max())
    print(f"  walk gate: launches (K1, K2, K3) {runs['kernel'][1]} with the "
          f"kernel, {runs['force_xla'][1]} under force_xla; max |kernel run "
          f"- plain run| = {gate_err:.3g}")
    require(runs["kernel"][1][0] > 0 and runs["kernel"][1][1:] == (0, 0)
            and runs["force_xla"][1] == (0, 0, 0) and gate_err <= ENGINE_TOL,
            f"walk gate {runs['kernel'][1]}, {runs['force_xla'][1]}, "
            f"{gate_err}")

    record = walk_prestage_kernel(eng, x)
    return {"launches": expected, "k1": record}


def dft_cubic_phase(gen, card: str) -> int:
    """48k -> 96k HIGH (dft_up, K1) through ``process_device`` /
    ``flush_device`` and through ``process``, and 44.1k -> 48k QUICK
    (cubic, no kernel) through ``process``, 256 streams x 2 s each;
    returns the dft_up device run's K1 launches."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine

    rng = np.random.default_rng(8)
    plan = plan_engine(DECIM_IN, 96000, Quality.HIGH)
    n = SMALL_SECONDS * DECIM_IN
    canonical = plan.lengths.canonical(n)
    x = 0.5 * torch.randn((SMALL_STREAMS, n), generator=gen, device="cuda")
    x_np = x.cpu().numpy()
    dev = EngineCore(plan, batch=SMALL_STREAMS, block=2048)
    require(plan.kind == "dft_up" and dev.device_chunk_multiple == 1,
            f"dft_up plan {plan.kind}")
    chunks = [(a, min(n, a + 2048)) for a in range(0, n, 2048)]
    expected = expected_launches(plan, n, len(chunks), 1, plan.factor,
                                 dev.block, plan.lengths.drop_prefix())
    reset_launches()
    t0 = time.perf_counter()
    outs = [dev.process_device(x[:, a:b]) for a, b in chunks]
    outs.append(dev.flush_device())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    y = torch.cat(outs, dim=1).cpu().numpy()
    host = EngineCore(plan, batch=SMALL_STREAMS, block=2048)
    reset_launches()
    y_host, wall_h, n_chunks = host_run(host, x_np, rng, host.block)
    host_launches = launch_counts()
    ref = EngineCore(plan, batch=4, block=2048, dtype=torch.float64,
                     device="cpu")
    want = np.concatenate([ref.process(x_np[:4].astype(np.float64)),
                           ref.flush()], axis=1)
    err = float(np.abs(y[:4] - want).max())
    same = bool(np.array_equal(y, y_host))
    print(f"  dft_up 48k->96k HIGH: {SMALL_STREAMS} streams x {n} samples: "
          f"process_device {SMALL_STREAMS * n / wall / 1e6:.1f} Msamples/s "
          f"in ({launches[0]} K1 launches), process() in {n_chunks} random "
          f"chunks {SMALL_STREAMS * n / wall_h / 1e6:.1f} Msamples/s in "
          f"({host_launches[0]} K1 launches) on {card}")
    print(f"  dft_up: length {y.shape[1]} == canonical {canonical}; "
          f"process_device equal to process() bit for bit: {same}; max |cuda "
          f"f32 - cpu f64| over 4 streams = {err:.3g}")
    require(y.shape == y_host.shape == (SMALL_STREAMS, canonical),
            f"dft_up outputs {y.shape}, {y_host.shape}, canonical {canonical}")
    require(launches == (expected, 0, 0) and host_launches[0] > 0
            and host_launches[1:] == (0, 0),
            f"dft_up launches {launches} (expected {expected}), process() "
            f"{host_launches}")
    require(same, "dft_up: process_device and process() differ")
    require(err <= ENGINE_TOL, f"dft_up vs float64: {err}")
    del x, y, y_host

    plan = plan_engine(RATE_IN, RATE_OUT, Quality.QUICK)
    n = SMALL_SECONDS * RATE_IN
    x_np = (0.5 * torch.randn((SMALL_STREAMS, n), generator=gen,
                              device="cuda")).cpu().numpy()
    eng = EngineCore(plan, batch=SMALL_STREAMS, block=2048)
    reset_launches()
    y, wall, n_chunks = host_run(eng, x_np, rng, eng.block)
    cubic_launches = launch_counts()
    ref = EngineCore(plan, batch=4, block=2048, dtype=torch.float64,
                     device="cpu")
    want = np.concatenate([ref.process(x_np[:4].astype(np.float64)),
                           ref.flush()], axis=1)
    err = float(np.abs(y[:4] - want).max())
    print(f"  cubic 44.1k->48k QUICK: {SMALL_STREAMS} streams x {n} samples "
          f"through process() in {n_chunks} random chunks: "
          f"{SMALL_STREAMS * n / wall / 1e6:.1f} Msamples/s in, launches "
          f"(K1, K2, K3) {cubic_launches}; length {y.shape[1]} == canonical "
          f"{plan.lengths.canonical(n)}; max |cuda f32 - cpu f64| over 4 "
          f"streams = {err:.3g} on {card}")
    require(y.shape == (SMALL_STREAMS, plan.lengths.canonical(n))
            and cubic_launches == (0, 0, 0) and err <= ENGINE_TOL,
            f"cubic: {y.shape}, launches {cubic_launches}, error {err}")
    return launches[0]



# -- strict antialias and banded composites ----------------------------------


def composite_plan(stages):
    """The banded composite of a stage chain as the JAX package's API
    fuses it (``api.Resampler._build_exec``): ``fuse_chain`` over 48
    kHz-based stage plans (``(output rate, strict antialias)`` each), the
    ratio their product, the latency their sum."""
    from go_audio_resampler_tpu_torch import Quality, plan_engine
    from go_audio_resampler_tpu_torch.pipeline import BandedPlan, fuse_chain
    plans = [plan_engine(48000, out, Quality.HIGH, strict_antialias=aa)
             for out, aa in stages]
    ratio = 1.0
    for p in plans:
        ratio *= float(p.ratio)
    return BandedPlan(fuse_chain(plans), ratio,
                      latency=sum(p.latency() for p in plans))


def k1_engine_shape(label: str, eng, gen, streams: int) -> dict:
    """K1 at an engine's step (``streams`` blocks behind the carry as its
    head, as the step launches it, against the engine's prepared operator)
    and at a ragged shape, each against its plain version within 2e-5 of
    max|y|; then timed beside it, ``F.conv1d`` and ``matmul`` on the
    ``unfold`` view of [carry ++ block], with its bounds (:func:`k1_at`)."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch.ops import fused

    r_t, ipx, wx, p2, carry, op = eng._band
    nf = eng.block // ipx
    x = torch.randn((5, 2 * ipx + wx + 7), generator=gen, device="cuda")
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=3, tier="highest")
    y = fused.fused_resample(x, r_t, op=op, **kw)
    ref = fused.fused_resample_reference(x, r_t, **kw)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item() / ref.abs().max().item()
    print(f"  K1 {label}: data {tuple(x.shape)}, R_t {(wx, p2)}, 3 frames, "
          f"ipx {ipx}, split {op.split}: max |kernel - plain| = {err:.3g} "
          "of max|y|")
    require(y.shape == (5, 3 * p2) and err <= KERNEL_TOL,
            f"K1 {label}: {tuple(y.shape)}, error {err}")
    # The step as the engine launches it: the carry (laid out as the step
    # leaves it) as the head, the block as the data.
    from go_audio_resampler_tpu_torch.engine.streaming import _next_carry
    x = torch.randn((streams, eng.block), generator=gen, device="cuda")
    head = _next_carry(torch.empty((streams, carry), device="cuda"),
                       torch.randn((streams, eng.block), generator=gen,
                                   device="cuda"))
    weight = r_t.t().contiguous()[:, None, :]
    rows = fused.virtual_row(x, head)
    lib_in = rows[:, None, :(nf - 1) * ipx + wx].contiguous()
    frames_v = rows.unfold(1, wx, ipx)[:, :nf]
    record = k1_at(
        label, x, r_t, ipx, p2, nf, op,
        {"library_conv1d_ms": lambda: F.conv1d(lib_in, weight, stride=ipx),
         "library_matmul_ms": lambda: torch.matmul(frames_v, r_t)},
        head=head)
    return {**record, "max_abs_err": max(err, record["max_abs_err"])}


def device_run(eng, x, chunks, canonical: int) -> tuple:
    """``x`` through ``eng.process_device`` in ``chunks``, then
    ``flush_device`` (the outputs' memory reserved beforehand): the
    output, the wall time (s) and the (K1, K2, K3) launches."""
    import torch
    torch.empty((x.shape[0], canonical + eng.block), device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [eng.process_device(x[:, a:b]) for a, b in chunks]
    outs.append(eng.flush_device())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return torch.cat(outs, dim=1), wall, launch_counts()


def float64_run(plan, x4: np.ndarray, block: int) -> np.ndarray:
    """The port's float64 CPU engine on ``x4``, as one chunk, then flushed."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore
    ref = EngineCore(plan, batch=x4.shape[0], block=block,
                     dtype=torch.float64, device="cpu")
    return np.concatenate([ref.process(x4.astype(np.float64)), ref.flush()],
                          axis=1)


def warm_steps(label: str, eng, x, card: str, steps: int = 40) -> dict:
    """Warm ``process_device`` steps of one block: host enqueue, wall and
    device span per step, and each kernel's device time from
    ``torch.profiler`` (the trace taken again, up to three times, when it
    holds none of the card's kernels)."""
    import torch
    blk = eng.block

    def run():
        for i in range(steps):
            eng.process_device(x[:, i * blk:(i + 1) * blk])

    eng.reset()
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
    for traces in range(1, 4):
        kernels = device_kernels(run, 1)
        busy = sum(ms for _, ms, _ in kernels) / steps
        if busy > 0:
            break
    require(busy > 0, f"{label}: no kernel in {traces} torch.profiler traces")
    k1 = sum(ms for name, ms, _ in kernels
             if "fused_resample_kernel" in name) / steps
    print(f"  {label}: {steps} warm steps of {x.shape[0]} streams x {blk}: "
          f"host enqueue {(t1 - t0) / steps * 1e3:.5f} ms/step, wall "
          f"{wall:.5f} ms/step, device span {device:.5f} ms/step; kernels "
          f"busy {busy:.5f} ms/step (K1 {k1:.5f}) under the profiler, trace "
          f"{traces} (device idle share {max(0.0, 1 - busy / wall):.3f}) on "
          f"{card}")
    for name, ms, count in kernels:
        print(f"  {label}: {ms / steps:.5f} ms/step, {count / steps:g} per "
              f"step: {name[:90]}")
    eng.reset()
    return {"enqueue_ms": (t1 - t0) / steps * 1e3, "busy_ms": busy,
            "idle": max(0.0, 1 - busy / wall)}


def composite_path(gen, card: str) -> dict:
    """Path A: 96 kHz -> 44.1 kHz HIGH, the banded composite with a 294-row
    head, 256 streams x 10 s through ``EngineCore.process_device`` in
    blocks, then ``flush_device``, and through ``process()`` in random
    chunks; returns K1's launches and its record at the composite's
    shape."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, TimeMajorEngine
    from go_audio_resampler_tpu_torch.utils import metrics, signals

    t0 = time.perf_counter()
    plan = composite_plan(((24000, False), (44100, True)))
    design_s = time.perf_counter() - t0
    op = plan.op
    require((op.P, op.I, op.W, op.lam, op.head.shape)
            == (147, 320, 2581, 490, (294, 2901)),
            f"composite 96k->44.1k: P {op.P}, I {op.I}, W {op.W}, lam "
            f"{op.lam}, head {op.head.shape}")
    eng = EngineCore(plan, batch=COMP_STREAMS, block=2048)
    r_t, ipx, wx, p2, carry, _ = eng._band
    require((tuple(r_t.shape), ipx, eng.block, carry, eng._drop)
            == ((3861, 735), 1600, 3200, 3690, 1470),
            f"composite engine: R_t {tuple(r_t.shape)}, ipx {ipx}, block "
            f"{eng.block}, carry {carry}")
    try:
        TimeMajorEngine(plan, batch=COMP_STREAMS, block=2048)
        refused = False
    except NotImplementedError:
        refused = True
    require(refused, "TimeMajorEngine took a composite with a head")
    # K1 at this shape first, then the engine that runs it.
    record = k1_engine_shape("composite 96k->44.1k", eng, gen, COMP_STREAMS)

    n = COMP_IN * SECONDS
    canonical = plan.lengths.canonical(n)
    x = 0.5 * torch.randn((COMP_STREAMS, n), generator=gen, device="cuda")
    x[0] = torch.as_tensor(signals.sine(n, 1000.0, COMP_IN),
                           dtype=torch.float32, device="cuda")
    x[1] = torch.as_tensor(signals.sine(n, 30000.0, COMP_IN),
                           dtype=torch.float32, device="cuda")
    steps = warm_steps("composite step", eng, x, card)
    chunks = [(a, min(n, a + eng.block)) for a in range(0, n, eng.block)]
    expected = expected_launches(plan, n, len(chunks), ipx, p2, eng.block,
                                 eng._drop)
    y, wall, counts = device_run(eng, x, chunks, canonical)
    require(tuple(y.shape) == (COMP_STREAMS, canonical),
            f"composite output {tuple(y.shape)}, canonical {canonical}")
    require(counts == (expected, 0, 0),
            f"composite launches {counts}, expected ({expected}, 0, 0)")
    require(bool(torch.isfinite(y).all()), "composite: non-finite output")
    x_np = x.cpu().numpy()
    y_np = y.cpu().numpy()
    del y
    host = EngineCore(plan, batch=COMP_STREAMS, block=2048)
    reset_launches()
    y_host, wall_h, n_chunks = host_run(host, x_np, np.random.default_rng(11),
                                        host.block)
    host_launches = launch_counts()
    same = bool(np.array_equal(y_np, y_host))
    del y_host
    want = float64_run(plan, x_np[:4], 2048)
    got = y_np[:4].astype(np.float64)
    y_max = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / y_max
    xe = np.zeros((4, op.head.shape[1]))
    xe[:, op.lam:] = x_np[:4, :op.head.shape[1] - op.lam]
    head_want = xe @ op.head.T
    head_err = float(np.abs(got[:, :op.n_head] - head_want).max()) / y_max
    thd = metrics.thd(got[0], COMP_OUT, 1000.0, 16384)
    mid = got[1][got.shape[1] // 4:-(got.shape[1] // 4)]
    alias = -20.0 * np.log10(max(np.sqrt(np.mean(mid ** 2)) * np.sqrt(2.0),
                                 1e-12))
    print(f"  composite 96k->44.1k HIGH: host design {design_s:.3f} s; "
          f"{COMP_STREAMS} streams x {n} samples through process_device in "
          f"{wall:.4f} s = {COMP_STREAMS * n / wall / 1e6:.1f} Msamples/s "
          f"in, {counts[0]} K1 launches, {len(chunks)} chunks "
          f"({wall / len(chunks) * 1e3:.4f} ms each); process() in "
          f"{n_chunks} random chunks {COMP_STREAMS * n / wall_h / 1e6:.1f} "
          f"Msamples/s in (launches (K1, K2, K3) {host_launches}) on {card}")
    print(f"  composite: length {y_np.shape[1]} == canonical {canonical}; "
          f"process_device equal to process() bit for bit: {same}; max |cuda "
          f"f32 - cpu f64| over 4 streams = {err:.3g} of max|y|, over the "
          f"first {op.n_head} outputs against the float64 head rows "
          f"{head_err:.3g}; THD of the 1 kHz stream = {thd:.2f} dB (floor "
          f"{THD_COMP_DB}); the 30 kHz tone rejected by {alias:.1f} dB "
          f"(floor {ALIAS_DB})")
    require(host_launches[0] > 0 and host_launches[1:] == (0, 0),
            f"composite process() launches {host_launches}")
    require(same, "composite: process_device and process() differ")
    require(err <= ENGINE_TOL and head_err <= ENGINE_TOL,
            f"composite vs float64: {err}, head {head_err}")
    require(thd <= THD_COMP_DB, f"composite THD {thd} dB > {THD_COMP_DB}")
    require(alias >= ALIAS_DB, f"composite alias rejection {alias} dB")
    return {"launches": counts[0], "k1": {**record, "launches": counts[0]},
            "steps": steps}


def strict_path(gen, card: str) -> dict:
    """Path B: 48 kHz -> 44.1 kHz HIGH with the strict-antialias prefilter
    composed into the exact operator, 1024 streams x 10 s through
    ``EngineCore.process_device`` and ``process()``; returns K1's
    launches and its record at the operator's shape."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.utils import metrics, signals

    plan = plan_engine(DECIM_IN, RATE_IN, Quality.HIGH, strict_antialias=True)
    eng = EngineCore(plan, batch=STRICT_STREAMS, block=2048)
    r_t, ipx, wx, p2, carry, _ = eng._band
    require(plan.aa_taps == 491 and (tuple(r_t.shape), ipx, eng.block, carry)
            == ((1161, 441), 480, 2400, 725),
            f"strict engine: aa {plan.aa_taps}, R_t {tuple(r_t.shape)}, ipx "
            f"{ipx}, block {eng.block}, carry {carry}")
    record = k1_engine_shape("strict 48k->44.1k", eng, gen, STRICT_STREAMS)
    n = DECIM_IN * SECONDS
    canonical = plan.lengths.canonical(n)
    x = 0.5 * torch.randn((STRICT_STREAMS, n), generator=gen, device="cuda")
    x[0] = torch.as_tensor(signals.sine(n, 1000.0, DECIM_IN),
                           dtype=torch.float32, device="cuda")
    chunks = [(a, min(n, a + eng.block)) for a in range(0, n, eng.block)]
    expected = expected_launches(plan, n, len(chunks), ipx, p2, eng.block,
                                 eng._drop)
    y, wall, counts = device_run(eng, x, chunks, canonical)
    require(tuple(y.shape) == (STRICT_STREAMS, canonical)
            and counts == (expected, 0, 0) and bool(torch.isfinite(y).all()),
            f"strict: output {tuple(y.shape)}, canonical {canonical}, "
            f"launches {counts} (expected {expected})")
    x_np = x.cpu().numpy()
    del x
    y_np = y.cpu().numpy()
    del y
    host = EngineCore(plan, batch=STRICT_STREAMS, block=2048)
    y_host, wall_h, n_chunks = host_run(host, x_np, np.random.default_rng(12),
                                        host.block)
    same = bool(np.array_equal(y_np, y_host))
    del y_host
    want = float64_run(plan, x_np[:4], 2048)
    got = y_np[:4].astype(np.float64)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    thd = metrics.thd(got[0], RATE_IN, 1000.0, 16384)
    print(f"  strict 48k->44.1k HIGH: {STRICT_STREAMS} streams x {n} samples "
          f"through process_device in {wall:.4f} s = "
          f"{STRICT_STREAMS * n / wall / 1e6:.1f} Msamples/s in, {counts[0]} "
          f"K1 launches, {len(chunks)} chunks; process() in {n_chunks} random"
          f" chunks {STRICT_STREAMS * n / wall_h / 1e6:.1f} Msamples/s in on "
          f"{card}")
    print(f"  strict: length {y_np.shape[1]} == canonical {canonical}; "
          f"process_device equal to process() bit for bit: {same}; max |cuda "
          f"f32 - cpu f64| over 4 streams = {err:.3g} of max|y|; THD of the "
          f"1 kHz stream = {thd:.2f} dB (floor {THD_FLOOR_DB})")
    require(same, "strict: process_device and process() differ")
    require(err <= ENGINE_TOL, f"strict vs float64: {err}")
    require(thd <= THD_FLOOR_DB, f"strict THD {thd} dB > {THD_FLOOR_DB}")
    return {"launches": counts[0], "k1": {**record, "launches": counts[0]}}


def head_free_path(gen, card: str) -> dict:
    """Path C: 192 kHz -> 48 kHz HIGH, the head-free composite of two 2x
    decimators, 256 streams x 10.003 s through ``TimeMajorEngine`` (K2)
    and ``EngineCore`` (K1); returns K2's launches and its record at the
    composite's shape."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch import EngineCore, TimeMajorEngine
    from go_audio_resampler_tpu_torch.ops import banded, fused, tmajor

    plan = composite_plan(((24000, False), (24000, False)))
    op = plan.op
    eng = EngineCore(plan, batch=C_STREAMS, block=2048)
    tm = TimeMajorEngine(plan, batch=C_STREAMS, block=2048)
    r_t, ipx, wx, p2, carry, kop = eng._band
    require((op.P, op.I, op.W, op.head) == (1, 4, 2701, None)
            and (tuple(r_t.shape), ipx, tm.block, tm.chunk_multiple, carry)
            == ((4497, 450), 1800, 3600, 1800, 3600),
            f"head-free composite: P {op.P}, I {op.I}, W {op.W}, R_t "
            f"{tuple(r_t.shape)}, ipx {ipx}, block {tm.block}")
    # K2 at the step's shape against its plain version and K1, then timed.
    nf = tm.block // ipx
    r = tm._r
    errs = []
    for s, frames, rows in ((C_STREAMS, nf, carry + tm.block),
                            (7, 3, 2 * ipx + wx + 5)):
        xt = torch.randn((rows, s), generator=gen, device="cuda")
        kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=frames, tier="highest")
        yk = tmajor.fused_resample_tmajor(xt, r, op=tm._op, **kw)
        ref = tmajor.fused_resample_tmajor_reference(xt, r, **kw)
        k1 = fused.fused_resample(xt.t().contiguous(), r_t, op=kop, **kw)
        torch.cuda.synchronize()
        err = (yk - ref).abs().max().item() / ref.abs().max().item()
        same = bool(torch.equal(yk, k1.t()))
        print(f"  K2 head-free composite: xT {tuple(xt.shape)}, R {(p2, wx)}, "
              f"{frames} frames, ipx {ipx}, split {tm._op.split}: max "
              f"|kernel - plain| = {err:.3g} of max|y|; equal to K1 bit for "
              f"bit: {same}")
        require(err <= KERNEL_TOL and same, f"K2 head-free composite: {err}, "
                f"equal to K1 {same}")
        errs.append(err)
    xt = torch.randn((carry + tm.block, C_STREAMS), generator=gen,
                     device="cuda")
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=nf, tier="highest")
    weight = r[:, None, :]
    lib_in = xt.t().contiguous()[:, None, :]
    frames_t = xt[:(nf - 1) * ipx + wx].unfold(0, wx, ipx).transpose(1, 2)
    timed = time_banded(
        "K2 head-free composite shape",
        lambda: tmajor.fused_resample_tmajor(xt, r, op=tm._op, **kw),
        lambda: tmajor.fused_resample_tmajor_reference(xt, r, **kw),
        {"library_conv1d_ms": lambda: F.conv1d(lib_in, weight, stride=ipx),
         "library_matmul_ms": lambda: torch.matmul(r, frames_t)},
        banded_cost(r_t, kop, C_STREAMS * nf,
                    C_STREAMS * ((nf - 1) * ipx + wx)))
    del xt, lib_in, frames_t

    n = C_SAMPLES
    canonical = plan.lengths.canonical(n)
    x = 0.5 * torch.randn((C_STREAMS, n), generator=gen, device="cuda")
    chunks = [(a, min(n, a + tm.block)) for a in range(0, n, tm.block)]
    expected = expected_launches(plan, n, len(chunks), ipx, p2, tm.block,
                                 tm._drop)
    y, wall, counts = device_run(eng, x, chunks, canonical)
    xt = x.t().contiguous()
    torch.empty((canonical + tm.block, C_STREAMS), device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [tm.process_device(xt[a:b]) for a, b in chunks]
    outs.append(tm.flush_device())
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    counts_t = launch_counts()
    yt = torch.cat(outs, dim=0)
    del outs, xt
    require(tuple(y.shape) == (C_STREAMS, canonical)
            and tuple(yt.shape) == (canonical, C_STREAMS),
            f"head-free outputs {tuple(y.shape)}, {tuple(yt.shape)}, "
            f"canonical {canonical}")
    require(counts == (expected, 0, 0) and counts_t == (0, expected, 0),
            f"head-free launches {counts} and {counts_t}, expected "
            f"{expected}")
    require(bool(torch.isfinite(yt).all()), "head-free: non-finite output")
    y_max = y.abs().max().item()
    vs_stream = (yt.t() - y).abs().max().item() / y_max
    same = bool(torch.equal(yt.t(), y))
    want = float64_run(plan, x[:4].cpu().numpy(), 2048)
    err = float(np.abs(yt[:, :4].t().cpu().double().numpy() - want).max()
                ) / float(np.abs(want).max())
    print(f"  head-free composite 192k->48k HIGH: {C_STREAMS} streams x {n} "
          f"samples: TimeMajorEngine {C_STREAMS * n / wall_t / 1e6:.1f} "
          f"Msamples/s in ({counts_t[1]} K2 launches), EngineCore "
          f"{C_STREAMS * n / wall / 1e6:.1f} Msamples/s in ({counts[0]} K1 "
          f"launches), {len(chunks)} chunks on {card}")
    print(f"  head-free composite: length {canonical} == canonical; max "
          f"|time-major - stream-major| = {vs_stream:.3g} of max|y| (bit for "
          f"bit: {same}); max |cuda f32 - cpu f64| over 4 streams = "
          f"{err:.3g} of max|y|")
    require(vs_stream <= ENGINE_TOL and err <= ENGINE_TOL,
            f"head-free composite: {vs_stream}, {err}")
    return {"launches": counts_t[1], "k1_launches": counts[0],
            "k2": {**timed, "max_abs_err": max(errs),
                   "launches": counts_t[1]}}


def strict_oneshot(card: str, cases) -> list:
    """Path E: ``oneshot`` of each (name, plan, x, K1 and K3 launches)
    case: lengths, exact launches, 4 streams against the float64 CPU
    ``oneshot`` within 2e-5 of max|y|; returns the outputs and the
    (K1, K2, K3) launches of all the calls."""
    import torch
    from go_audio_resampler_tpu_torch import oneshot

    ys, total = [], np.zeros(3, dtype=int)
    for name, plan, x, (want_k1, want_k3) in cases:
        n = x.shape[1]
        reset_launches()
        t0 = time.perf_counter()
        y = oneshot(plan, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        want = oneshot(plan, x[:4].cpu().double().numpy(),
                       device="cpu").numpy()
        err = float(np.abs(y[:4].cpu().double().numpy() - want).max()
                    ) / float(np.abs(want).max())
        print(f"  one-shot {name}: [{x.shape[0]}, {n}] -> {tuple(y.shape)} =="
              f" canonical; launches (K1, K2, K3) {counts}; max |cuda f32 - "
              f"cpu f64| over 4 streams = {err:.3g} of max|y|; entry point "
              f"(host design included) {wall:.4f} s on {card}")
        require(tuple(y.shape) == (x.shape[0], plan.lengths.canonical(n))
                and bool(torch.isfinite(y).all()),
                f"one-shot {name}: {tuple(y.shape)}")
        require(counts == (want_k1, 0, want_k3),
                f"one-shot {name}: launches {counts}")
        require(err <= ENGINE_TOL, f"one-shot {name}: {err}")
        ys.append(y)
        total += counts
    return ys, tuple(int(c) for c in total)


def strict_walk_path(gen, card: str) -> dict:
    """Path D: 48 kHz -> 44.099 kHz HIGH, the non-exact walk behind the
    strict-antialias prefilter, 256 streams x 2 s through ``process()`` in
    random chunks, then ``flush()``; path E, the one-shot of paths B and D
    on 64 of its streams; returns the K1 launches of each and K1's record
    at the prefilter's shape."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.ops import convolve, fused

    plan = plan_engine(DECIM_IN, D_OUT, Quality.HIGH, strict_antialias=True)
    eng = EngineCore(plan, batch=D_STREAMS, block=2048)
    band = eng._aa_band
    t = plan.aa_taps
    require(plan.kind == "two_stage" and not plan.is_rational_exact
            and t == 491 and eng.block == 2048 and band.p == 128
            and tuple(band.r_t.shape) == (t - 1 + 128, 128),
            f"strict walk: aa {t}, block {eng.block}, band {band.p}, "
            f"{tuple(band.r_t.shape)}")
    # K1 at the prefilter's shape against its plain version, then timed.
    h = eng._aa_coeffs[None, :]
    xk = torch.randn((D_STREAMS, t - 1 + eng.block), generator=gen,
                     device="cuda")
    wx, p2 = band.r_t.shape
    nf = eng.block // band.p
    kw = dict(ipx=band.p, wx=wx, p2=p2, n_frames=nf, tier="highest")
    reset_launches()
    yk = convolve._conv_banded(xk, h, 1, band=band, tier="highest")[:, 0]
    launched = launch_counts()
    ref = fused.fused_resample_reference(xk, band.r_t, **kw)[:, :eng.block]
    lib_in, weight = xk[:, None, :], h[:, None, :].contiguous()
    lib = F.conv1d(lib_in, weight)[:, 0]
    torch.cuda.synchronize()
    err_k = (yk - ref).abs().max().item() / ref.abs().max().item()
    lib_err = (yk - lib).abs().max().item() / ref.abs().max().item()
    print(f"  K1 prefilter: data {tuple(xk.shape)}, R_t {(wx, p2)}, {nf} "
          f"frames, ipx {band.p}, split {band.op.split}: max |kernel - "
          f"plain| = {err_k:.3g} of max|y|, max |kernel - F.conv1d| = "
          f"{lib_err:.3g}")
    require(launched == (1, 0, 0) and err_k <= KERNEL_TOL
            and lib_err <= KERNEL_TOL,
            f"K1 prefilter: launches {launched}, {err_k}, {lib_err}")
    timed = time_banded(
        "K1 prefilter shape",
        lambda: convolve._conv_banded(xk, h, 1, band=band, tier="highest"),
        lambda: fused.fused_resample_reference(xk, band.r_t, **kw),
        {"library_conv1d_ms": lambda: F.conv1d(lib_in, weight)},
        banded_cost(band.r_t, band.op, D_STREAMS * nf,
                    D_STREAMS * xk.shape[1]))
    del xk, lib_in, lib

    n = SMALL_SECONDS * DECIM_IN
    x = 0.5 * torch.randn((D_STREAMS, n), generator=gen, device="cuda")
    x_np = x.cpu().numpy()
    lm = plan.lengths
    z, d, blk = lm.flush_pad(n), eng._aa_delay, eng.block
    expected = (n // blk + -(-(n % blk + z + d) // blk)
                + walk_launches(plan, n, blk))
    reset_launches()
    y, wall, n_chunks = host_run(eng, x_np, np.random.default_rng(13), blk)
    counts = launch_counts()
    canonical = lm.canonical(n)
    require(y.shape == (D_STREAMS, canonical) and np.isfinite(y).all(),
            f"strict walk: output {y.shape}, canonical {canonical}")
    require(counts == (expected, 0, 0),
            f"strict walk launches {counts}, expected ({expected}, 0, 0)")
    want = float64_run(plan, x_np[:4], 2048)
    err = float(np.abs(y[:4] - want).max()) / float(np.abs(want).max())

    # Path E: the one-shot of B and D; D's on the walk's first 64 streams.
    b_plan = plan_engine(DECIM_IN, RATE_IN, Quality.HIGH,
                         strict_antialias=True)
    xb = 0.5 * torch.randn((ONESHOT_STREAMS, ONESHOT_SECONDS * DECIM_IN),
                           generator=gen, device="cuda")
    (yb, yd), oneshot_counts = strict_oneshot(card, [
        ("48k->44.1k HIGH strict (K1, lam)", b_plan, xb, (1, 0)),
        ("48k->44.099k HIGH strict (prefilter on K1, then K3)", plan,
         x[:ONESHOT_STREAMS], (1, 1))])
    yd = yd.cpu().numpy()
    vs_oneshot = float(np.abs(y[:ONESHOT_STREAMS] - yd).max()
                       ) / float(np.abs(yd).max())
    print(f"  strict walk 48k->44.099k HIGH: {D_STREAMS} streams x {n} "
          f"samples through process() in {n_chunks} random chunks in "
          f"{wall:.4f} s = {D_STREAMS * n / wall / 1e6:.1f} Msamples/s in, "
          f"launches (K1, K2, K3) {counts} (prefilter and prestage, "
          f"{expected - walk_launches(plan, n, blk)} + "
          f"{walk_launches(plan, n, blk)}) on {card}")
    print(f"  strict walk: length {y.shape[1]} == canonical {canonical}; max "
          f"|cuda f32 - cpu f64| over 4 streams = {err:.3g} of max|y|; max "
          f"|walk - one-shot| over {ONESHOT_STREAMS} streams = "
          f"{vs_oneshot:.3g} of max|y|")
    require(err <= ENGINE_TOL, f"strict walk vs float64: {err}")
    require(yd.shape == y[:ONESHOT_STREAMS].shape
            and vs_oneshot <= WALK_VS_ONESHOT,
            f"strict walk vs one-shot: {yd.shape}, {vs_oneshot}")
    return {"launches": counts[0],
            "k1": {**timed, "max_abs_err": err_k,
                   "launches": expected - walk_launches(plan, n, blk)},
            "oneshot_k1": oneshot_counts[0], "oneshot_k3": oneshot_counts[2]}


# -- public API and FFT routes (phase 12) ------------------------------------

#: Phase 12: the public API's chains at its widest batch (MAX_CHANNELS =
#: 256 channels of 10 s each) and the FFT overlap-save routes.  The FFT
#: routes' float32 tolerance against K1 is tests/test_fftstage.py:56-63's.
API_CHANNELS = 256
FFT_TOL = 1e-5


def timed(fn):
    """``fn()`` between two CUDA events: its result, the wall time (s) to
    the end of the device's work, and the device span (ms) between the
    events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def api_resampler(rate_in, rate_out, preset, channels=API_CHANNELS, **kw):
    """``new_resampler`` of the port's public API, on the card unless
    ``device`` says otherwise."""
    import go_audio_resampler_tpu_torch as gar
    return gar.new_resampler(gar.Config(
        rate_in, rate_out, channels=channels,
        quality=gar.QualitySpec(preset=gar.QualityPreset(preset)), **kw))


def api_float64(rate_in, rate_out, preset, x4: np.ndarray) -> np.ndarray:
    """The public API's float64 CPU run on ``x4``: ``process_multi`` of the
    whole input, then ``flush_multi``."""
    r = api_resampler(rate_in, rate_out, preset, channels=x4.shape[0],
                      device="cpu")
    return np.concatenate([np.stack(r.process_multi(list(
        x4.astype(np.float64)))), np.stack(r.flush_multi())], axis=1)


def rel(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max |want| (shapes must agree)."""
    require(got.shape == want.shape, f"shapes {got.shape} and {want.shape}")
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


def api_input(gen, rate: int, n: int, tones=(1000.0,)):
    """[API_CHANNELS, n] float32 noise on the card, the first channels
    sines at ``tones``."""
    import torch
    from go_audio_resampler_tpu_torch.utils import signals
    x = 0.5 * torch.randn((API_CHANNELS, n), generator=gen, device="cuda")
    for i, f in enumerate(tones):
        x[i] = torch.as_tensor(signals.sine(n, f, rate), dtype=torch.float32,
                               device="cuda")
    return x


class ResamplerSteps:
    """A ``Resampler`` seen as a streaming engine by :func:`timed_run`
    and :func:`warm_steps`: its device route, one engine block a step."""

    def __init__(self, r):
        self.r, self.block = r, r._exec[0].block

    def process_device(self, x):
        return self.r.process_multi_device(x)

    def flush_device(self):
        return self.r.flush_multi_device()

    def reset(self):
        self.r.reset()


def device_route(eng, x, chunks):
    """``x`` through ``eng.process_device`` in ``chunks``, then
    ``eng.flush_device``, twice (the second after ``reset()``, its
    allocator cache warm); ``eng`` is an engine, or a ``Resampler``,
    whose device route is then ``process_multi_device`` and
    ``flush_multi_device``.  Returns the first run's output on the card,
    its (K1, K2, K3) launches, and each run's :func:`timed_run` record.
    The runs must agree bit for bit and in launches."""
    import torch
    steps = eng if hasattr(eng, "process_device") else ResamplerSteps(eng)
    records, ys, counts = [], [], []
    for _ in range(2):
        steps.reset()
        reset_launches()
        outs, st = timed_run(steps, lambda a, b: x[:, a:b], chunks)
        counts.append(launch_counts())
        ys.append(torch.cat(outs, dim=1))
        records.append(st)
        del outs
    require(counts[0] == counts[1] and torch.equal(ys[0], ys[1]),
            f"the warm run differs: launches {counts}")
    return ys[0], counts[0], records


def route_line(n_in: int, records) -> str:
    """The cold and warm runs of :func:`device_route`, as printed."""
    return "; ".join(
        f"{name} {st['wall']:.4f} s = {n_in / st['wall'] / 1e6:.1f} "
        f"Msamples/s in, {run_stats(st)}"
        for name, st in zip(("cold", "warm"), records))


def api_a(gen, card: str) -> int:
    """API-A: 44.1k -> 48k HIGH through ``new_resampler``, 256 channels x
    10 s: the device route against ``EngineCore`` on the Resampler's own
    plan (bit for bit), ``process_multi`` and ``stream_multi`` against it
    (bit for bit), 4 channels against the float64 CPU run, K1 launches and
    THD; returns K1's launches."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore
    from go_audio_resampler_tpu_torch.utils import metrics

    r = api_resampler(RATE_IN, RATE_OUT, 3, dtype=np.float32,
                      max_input_size=BLOCK)
    eng = r._exec[0]
    mult = r.device_chunk_multiple
    require(len(r._exec) == 1 and eng.device.type == "cuda"
            and eng.block == BLOCK and mult and BLOCK % mult == 0,
            f"API-A: exec {[e.plan.kind for e in r._exec]}, block "
            f"{eng.block}, multiple {mult}")
    ipx, p2 = eng._period
    n = RATE_IN * SECONDS
    chunks = [(a, min(n, a + BLOCK)) for a in range(0, n, BLOCK)]
    require(all((b - a) % mult == 0 for a, b in chunks),
            "API-A: a chunk is not a multiple of the device granule")
    x = api_input(gen, RATE_IN, n)
    canonical = eng.plan.lengths.canonical(n)
    torch.empty((API_CHANNELS, canonical + BLOCK), device="cuda")
    y, counts, records = device_route(r, x, chunks)
    expected = expected_launches(eng.plan, n, len(chunks), ipx, p2,
                                 eng.block, eng._drop)
    require(tuple(y.shape) == (API_CHANNELS, canonical)
            and counts == (expected, 0, 0)
            and bool(torch.isfinite(y).all()),
            f"API-A: output {tuple(y.shape)}, canonical {canonical}, "
            f"launches {counts} (expected ({expected}, 0, 0))")
    direct = EngineCore(eng.plan, batch=API_CHANNELS, block=BLOCK)
    outs, direct_st = timed_run(direct, lambda a, b: x[:, a:b], chunks)
    same_direct = bool(torch.equal(y, torch.cat(outs, dim=1)))
    del outs
    # The wrapper's cost a step: warm steps through the Resampler and
    # through its engine.
    steps_api = warm_steps("API-A step, Resampler.process_multi_device",
                           ResamplerSteps(r), x, card)
    steps_eng = warm_steps("API-A step, EngineCore.process_device", direct,
                           x, card)
    del direct
    y_np = y.cpu().numpy()
    del y
    x_np = x.cpu().numpy()
    del x
    r.reset()
    y_multi, wall_m, dev_m = timed(lambda: np.concatenate(
        [np.stack(r.process_multi(list(x_np))), np.stack(r.flush_multi())],
        axis=1))
    same_multi = bool(np.array_equal(y_multi, y_np))
    del y_multi
    r.reset()
    step = 16 * BLOCK
    y_stream, wall_s, dev_s = timed(lambda: np.concatenate(list(
        r.stream_multi(x_np[:, a:a + step] for a in range(0, n, step))),
        axis=1))
    same_stream = bool(np.array_equal(y_stream, y_np))
    del y_stream
    want = api_float64(RATE_IN, RATE_OUT, 3, x_np[:4])
    err = rel(y_np[:4], want)
    thd = metrics.thd(y_np[0].astype(np.float64), RATE_OUT, 1000.0, 16384)
    rate = API_CHANNELS * n / 1e6
    print(f"  API-A 44.1k->48k HIGH, new_resampler(Config(channels="
          f"{API_CHANNELS}, float32, max_input_size={BLOCK})): plan "
          f"{eng.plan.kind}, R_t {tuple(eng._band.r_t.shape)} over {ipx}; "
          f"process_multi_device in {len(chunks)} chunks + "
          f"flush_multi_device: {route_line(rate * 1e6, records)}; launches "
          f"(K1, K2, K3) {counts} (derived {expected}); EngineCore on its "
          f"plan {direct_st['wall']:.4f} s = {rate / direct_st['wall']:.1f} "
          f"Msamples/s in, {run_stats(direct_st)}; warm steps: host enqueue "
          f"{steps_api['enqueue_ms']:.5f} ms (Resampler) and "
          f"{steps_eng['enqueue_ms']:.5f} ms (EngineCore), idle "
          f"{steps_api['idle']:.3f} and {steps_eng['idle']:.3f}; "
          f"process_multi + flush_multi {wall_m:.4f} "
          f"s = {rate / wall_m:.1f} Msamples/s in (span {dev_m:.3f} ms); "
          f"stream_multi(out='host') {wall_s:.4f} s = {rate / wall_s:.1f} "
          f"Msamples/s in (span {dev_s:.3f} ms) on {card}")
    print(f"  API-A: length {y_np.shape[1]} == canonical {canonical}; equal "
          f"bit for bit to EngineCore on r._exec[0].plan at block {BLOCK}: "
          f"{same_direct}, to process_multi: {same_multi}, to stream_multi: "
          f"{same_stream}; max |cuda f32 - cpu f64| over 4 channels = "
          f"{err:.3g} of max|y|; THD of the 1 kHz channel = {thd:.2f} dB "
          f"(floor {THD_FLOOR_DB})")
    require(same_direct and same_multi and same_stream,
            "API-A: the routes differ")
    require(err <= ENGINE_TOL, f"API-A vs float64: {err}")
    require(thd <= THD_FLOOR_DB, f"API-A THD {thd} dB")
    return counts[0]


def alias_db(y: np.ndarray) -> float:
    """Rejection (dB) of a unit tone whose alias is ``y``: its middle
    half's RMS, as a peak amplitude, below 0 dBFS."""
    mid = y[y.shape[0] // 4:-(y.shape[0] // 4)]
    return -20.0 * np.log10(max(np.sqrt(np.mean(mid ** 2)) * np.sqrt(2.0),
                                1e-12))


def api_b(gen, card: str) -> int:
    """API-B: 96k -> 44.1k HIGH through ``new_resampler`` (the auto strict
    antialias and the composite with head rows), 256 channels x 10 s
    through the device route; returns K1's launches."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    r = api_resampler(COMP_IN, COMP_OUT, 3)
    build_s = time.perf_counter() - t0
    eng = r._exec[0]
    op = eng.plan.op
    require(len(r._exec) == 1 and eng.plan.kind == "banded"
            and op.head is not None and r.dtype == np.float32,
            f"API-B: exec {[e.plan.kind for e in r._exec]}, dtype {r.dtype}")
    stage_plans = [e.plan for e in r._engines]
    p11 = [plan_engine(48000, out, Quality.HIGH, strict_antialias=aa)
           for out, aa in ((24000, False), (44100, True))]
    same_plans = [a.fingerprint == b.fingerprint
                  for a, b in zip(stage_plans, p11)]
    print(f"  API-B 96k->44.1k HIGH: {len(r._engines)} stages (aa taps "
          f"{[p.aa_taps for p in stage_plans]}, phase 11's "
          f"{[p.aa_taps for p in p11]}); stage plans equal to phase 11's: "
          f"{same_plans}; composite P {op.P}, I {op.I}, W {op.W}, lam "
          f"{op.lam}, head {op.head.shape}; built in {build_s:.3f} s")
    mult = r.device_chunk_multiple
    n = COMP_IN * SECONDS
    chunks = [(a, min(n, a + eng.block)) for a in range(0, n, eng.block)]
    require(all((b - a) % mult == 0 for a, b in chunks),
            f"API-B: chunks not multiples of {mult}")
    x = api_input(gen, COMP_IN, n, tones=(1000.0, 30000.0))
    canonical = eng.plan.lengths.canonical(n)
    torch.empty((API_CHANNELS, canonical + eng.block), device="cuda")
    ipx, p2 = eng._period
    y, counts, records = device_route(r, x, chunks)
    expected = expected_launches(eng.plan, n, len(chunks), ipx, p2,
                                 eng.block, eng._drop)
    require(tuple(y.shape) == (API_CHANNELS, canonical)
            and counts == (expected, 0, 0)
            and bool(torch.isfinite(y).all()),
            f"API-B: output {tuple(y.shape)}, launches {counts} (expected "
            f"{expected})")
    if all(same_plans):
        ref = EngineCore(composite_plan(((24000, False), (44100, True))),
                         batch=API_CHANNELS, block=eng.block)
        y_ref = torch.cat([ref.process_device(x[:, a:b]) for a, b in chunks]
                          + [ref.flush_device()], dim=1)
        same = bool(torch.equal(y, y_ref))
        del y_ref, ref
        print(f"  API-B: equal bit for bit to phase 11's composite engine at "
              f"block {eng.block}: {same}")
        require(same, "API-B differs from phase 11's composite engine")
    y_np = y.cpu().numpy()
    del y
    x4 = x[:4].cpu().numpy()
    del x
    want = api_float64(COMP_IN, COMP_OUT, 3, x4)
    err = rel(y_np[:4], want)
    thd = metrics.thd(y_np[0].astype(np.float64), COMP_OUT, 1000.0, 16384)
    alias = alias_db(y_np[1].astype(np.float64))
    print(f"  API-B: {API_CHANNELS} channels x {n} samples through "
          f"process_multi_device in {len(chunks)} chunks of {eng.block}: "
          f"{route_line(API_CHANNELS * n, records)}; launches (K1, K2, K3) "
          f"{counts}; "
          f"length {y_np.shape[1]} == canonical {canonical}; max |cuda f32 - "
          f"cpu f64| over 4 channels = {err:.3g} of max|y|; THD of the 1 kHz "
          f"channel = {thd:.2f} dB (floor {THD_COMP_DB}); the 30 kHz tone "
          f"rejected by {alias:.1f} dB (floor {ALIAS_DB}) on {card}")
    require(err <= ENGINE_TOL, f"API-B vs float64: {err}")
    require(thd <= THD_COMP_DB, f"API-B THD {thd} dB")
    require(alias >= ALIAS_DB, f"API-B alias rejection {alias} dB")
    return counts[0]


def api_c(gen, card: str) -> dict:
    """API-C: 48k -> 16k HIGH through ``new_resampler`` (a half-band and
    a polyphase stage fused into one composite): K1 at its step's shape
    against its plain version, timed beside ``F.conv1d`` with its bound;
    256 channels x 10 s through the device route; returns K1's record."""
    import torch

    r = api_resampler(DECIM_IN, DECIM_OUT, 3)
    eng = r._exec[0]
    kinds = [s.type.name for s in r.pipeline.stages]
    require(kinds == ["HALF_BAND", "POLYPHASE"] and len(r._exec) == 1
            and eng.plan.kind == "banded" and eng.plan.op.head is None,
            f"API-C: stages {kinds}, exec {[e.plan.kind for e in r._exec]}")
    r_t, ipx, wx, p2, carry, _ = eng._band
    print(f"  API-C 48k->16k HIGH: stages {kinds}, composite R_t "
          f"{tuple(r_t.shape)} over ipx {ipx}, block {eng.block}, carry "
          f"{carry}; the step's K1 shape is [{API_CHANNELS}, "
          f"{carry + eng.block}] x R_t {tuple(r_t.shape)}, "
          f"{eng.block // ipx} frame(s)")
    record = k1_engine_shape("API 48k->16k", eng, gen, API_CHANNELS)
    n = DECIM_IN * SECONDS
    n -= n % eng.block
    chunks = [(a, a + eng.block) for a in range(0, n, eng.block)]
    x = api_input(gen, DECIM_IN, n)
    canonical = eng.plan.lengths.canonical(n)
    torch.empty((API_CHANNELS, canonical + eng.block), device="cuda")
    y, counts, records = device_route(r, x, chunks)
    expected = expected_launches(eng.plan, n, len(chunks), ipx, p2,
                                 eng.block, eng._drop)
    require(tuple(y.shape) == (API_CHANNELS, canonical)
            and counts == (expected, 0, 0),
            f"API-C: output {tuple(y.shape)}, launches {counts} (expected "
            f"{expected})")
    err = rel(y[:4].cpu().numpy(),
              api_float64(DECIM_IN, DECIM_OUT, 3, x[:4].cpu().numpy()))
    print(f"  API-C: {API_CHANNELS} channels x {n} samples through "
          f"process_multi_device in {len(chunks)} chunks: "
          f"{route_line(API_CHANNELS * n, records)}; launches (K1, K2, K3) "
          f"{counts}; length "
          f"{y.shape[1]} == canonical {canonical}; max |cuda f32 - cpu f64| "
          f"over 4 channels = {err:.3g} of max|y| on {card}")
    require(err <= ENGINE_TOL, f"API-C vs float64: {err}")
    return {**record, "launches": counts[0]}


def api_d(gen, card: str) -> tuple:
    """API-D: 44.1k -> 3001 VERY_HIGH through ``new_resampler``: a
    composite segment, then the non-exact walk behind its prefilter;
    256 channels x 10 s through ``process_multi``/``flush_multi``;
    returns the (K1, K2, K3) launches."""
    r = api_resampler(RATE_IN, 3001, 4)
    kinds = [e.plan.kind for e in r._exec]
    require(kinds == ["banded", "two_stage"]
            and r.device_chunk_multiple is None,
            f"API-D: exec {kinds}, granule {r.device_chunk_multiple}")
    try:
        r.process_multi_device(np.zeros((API_CHANNELS, 1024), np.float32))
        refused = ""
    except NotImplementedError as err:
        refused = str(err)
    require("segment" in refused and r._entry_mode is None,
            f"API-D: process_multi_device did not refuse ({refused!r})")
    walk = r._exec[1]
    n = RATE_IN * SECONDS
    x_np = api_input(gen, RATE_IN, n).cpu().numpy()
    reset_launches()
    y, wall, dev = timed(lambda: np.concatenate(
        [np.stack(r.process_multi(list(x_np))), np.stack(r.flush_multi())],
        axis=1))
    counts = launch_counts()
    require(y.shape[0] == API_CHANNELS and np.isfinite(y).all()
            and counts[0] > 0 and counts[1] == 0,
            f"API-D: output {y.shape}, launches {counts}")
    want = api_float64(RATE_IN, 3001, 4, x_np[:4])
    err = rel(y[:4], want)
    print(f"  API-D 44.1k->3001 VERY_HIGH: exec {kinds} (the walk's "
          f"prefilter {walk.plan.aa_taps} taps, "
          f"{'FFT' if walk._aa_spec is not None else 'K1'}); "
          f"device_chunk_multiple None, process_multi_device refused: "
          f"{refused[:60]!r}...; {API_CHANNELS} channels x {n} samples "
          f"through process_multi + flush_multi in {wall:.4f} s = "
          f"{API_CHANNELS * n / wall / 1e6:.1f} Msamples/s in, span "
          f"{dev:.3f} ms, launches (K1, K2, K3) {counts}; length "
          f"{y.shape[1]}; max |cuda f32 - cpu f64| over 4 channels = "
          f"{err:.3g} of max|y| on {card}")
    require(err <= ENGINE_TOL, f"API-D vs float64: {err}")
    return counts


def convenience_phase(gen, card: str) -> tuple:
    """``resample_stereo`` at 44.1k -> 48k (K1) and ``resample_mono`` at
    44.1k -> 48.001k (K3), 1 s, each against the float64 CPU run;
    ``new_engine_float32`` against ``EngineCore`` at its block, 10 s,
    bit for bit; returns the (K1, K3) launches of the one-shots."""
    import torch
    import go_audio_resampler_tpu_torch as gar
    from go_audio_resampler_tpu_torch import EngineCore

    x = (0.5 * torch.randn((2, RATE_IN), generator=gen, device="cuda")
         ).cpu().double().numpy()
    reset_launches()
    (lo, ro), wall_s, dev_s = timed(lambda: gar.resample_stereo(
        x[0], x[1], RATE_IN, RATE_OUT))
    stereo = launch_counts()
    want = np.stack(gar.resample_stereo(x[0], x[1], RATE_IN, RATE_OUT,
                                        device="cpu"))
    require(lo.dtype == np.float64, f"resample_stereo returned {lo.dtype}")
    err_s = rel(np.stack([lo, ro]), want)
    reset_launches()
    ym, wall_m, dev_m = timed(lambda: gar.resample_mono(x[0], RATE_IN,
                                                        WALK_OUT))
    mono = launch_counts()
    err_m = rel(ym, gar.resample_mono(x[0], RATE_IN, WALK_OUT,
                                      device="cpu"))
    e = gar.new_engine_float32(RATE_IN, RATE_OUT)
    ref = EngineCore(e.plan, batch=1, block=2048)
    xs = (0.5 * torch.randn(RATE_IN * SECONDS, generator=gen,
                            device="cuda")).cpu().numpy()
    cuts = [0] + sorted(np.random.default_rng(14).integers(
        1, xs.size, 40).tolist()) + [xs.size]
    got = np.concatenate([e.process(xs[a:b]) for a, b in zip(cuts[:-1],
                                                             cuts[1:])]
                         + [e.flush()])
    direct = np.concatenate([ref.process(xs[None]), ref.flush()], axis=1)[0]
    same = got.dtype == np.float32 and bool(np.array_equal(got, direct))
    print(f"  convenience: resample_stereo 44.1k->48k [2, {RATE_IN}] in "
          f"{wall_s:.4f} s (span {dev_s:.3f} ms, host design included), "
          f"launches (K1, K2, K3) {stereo}, max |cuda - cpu f64| = "
          f"{err_s:.3g} of max|y|; resample_mono 44.1k->48.001k in "
          f"{wall_m:.4f} s (span {dev_m:.3f} ms), launches {mono}, "
          f"{err_m:.3g} of max|y|; new_engine_float32 over {len(cuts) - 1} "
          f"random chunks of {xs.size} samples equal bit for bit to "
          f"EngineCore at block 2048: {same} on {card}")
    require(stereo == (1, 0, 0) and mono == (0, 0, 1),
            f"convenience launches {stereo}, {mono}")
    require(err_s <= ENGINE_TOL and err_m <= ENGINE_TOL,
            f"convenience vs float64: {err_s}, {err_m}")
    require(same, "new_engine_float32 differs from EngineCore")
    return stereo[0], mono[2]


def fft_oneshot_phase(gen, card: str) -> None:
    """FFT-1: ``fft_oneshot`` (cuFFT) against ``oneshot`` (K1), 64 x 2 s,
    at decimate 96k -> 48k VERY_HIGH and dft_up 48k -> 96k HIGH, with the
    device time of each route's kernels (``torch.profiler``)."""
    import torch
    from go_audio_resampler_tpu_torch import Quality, oneshot, plan_engine
    from go_audio_resampler_tpu_torch.engine import fftstage

    for name, plan, rate in (
            ("decimate 96k->48k VERY_HIGH",
             plan_engine(COMP_IN, DECIM_IN, Quality.VERY_HIGH), COMP_IN),
            ("dft_up 48k->96k HIGH",
             plan_engine(DECIM_IN, COMP_IN, Quality.HIGH), DECIM_IN)):
        require(plan.kind != "decimate" or plan.decim_taps == 1069,
                f"FFT-1: {plan.decim_taps} taps")
        x = 0.5 * torch.randn((ONESHOT_STREAMS, ONESHOT_SECONDS * rate),
                              generator=gen, device="cuda")
        reset_launches()
        y_fft, wall, dev = timed(lambda: fftstage.fft_oneshot(plan, x))
        fft_counts = launch_counts()
        y_k1 = oneshot(plan, x)
        err = rel(y_fft.cpu().numpy(), y_k1.cpu().double().numpy())
        rows = {}
        for route, fn in (("cuFFT", lambda: fftstage.fft_oneshot(plan, x)),
                          ("K1", lambda: oneshot(plan, x))):
            for traces in range(1, 4):
                ks = device_kernels(fn, 3)
                if ks:
                    break
            require(ks, f"FFT-1 {name}: no {route} kernel traced")
            rows[route] = ks
        taps = plan.decim_taps if plan.kind == "decimate" else (
            plan.pre_taps * plan.factor)
        n_fft = fftstage._fft_len(taps)
        print(f"  FFT-1 {name} ({taps} taps, N = {n_fft}): fft_oneshot "
              f"[{x.shape[0]}, {x.shape[1]}] -> {tuple(y_fft.shape)} in "
              f"{wall:.4f} s (span {dev:.3f} ms, spectrum included), "
              f"launches (K1, K2, K3) {fft_counts}; max |cuFFT - K1| = "
              f"{err:.3g} of max|y|; device time per call: cuFFT route "
              f"{sum(r[1] for r in rows['cuFFT']):.5f} ms, K1 route "
              f"{sum(r[1] for r in rows['K1']):.5f} ms on {card}")
        for route, ks in rows.items():
            for kname, ms, count in ks[:6]:
                print(f"    {route}: {ms:.5f} ms, {count:g} per call: "
                      f"{kname[:90]}")
        require(fft_counts == (0, 0, 0), f"FFT-1: launches {fft_counts}")
        require(y_fft.shape == y_k1.shape and err <= FFT_TOL,
                f"FFT-1 {name}: {tuple(y_fft.shape)}, {err}")


def fft_prefilter_path(gen, card: str) -> int:
    """FFT-2: ``EngineCore`` of 44.1k -> 3001 VERY_HIGH with the 7,841-tap
    prefilter (FFT overlap-save), 256 streams x 10 s through
    ``process()``; returns K1's launches (the walk's prestage)."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.engine import streaming

    plan = plan_engine(RATE_IN, 3001, Quality.VERY_HIGH,
                       strict_antialias=True)
    eng = EngineCore(plan, batch=API_CHANNELS, block=2048)
    spec = eng._aa_spec
    require(plan.aa_taps == 7841 and spec is not None
            and eng._aa_band is None and spec.n == 32768,
            f"FFT-2: aa {plan.aa_taps}, spectrum {spec and spec.n}")
    blk = eng.block
    carry = torch.zeros((API_CHANNELS, plan.aa_taps - 1), device="cuda")
    xb = torch.randn((API_CHANNELS, blk), generator=gen, device="cuda")
    step_ms = cuda_ms(lambda: streaming._fir_fft_step(spec, carry, xb), 20)
    ks = device_kernels(lambda: streaming._fir_fft_step(spec, carry, xb), 3)
    del carry, xb
    n = RATE_IN * SECONDS
    x_np = (0.5 * torch.randn((API_CHANNELS, n), generator=gen,
                              device="cuda")).cpu().numpy()
    reset_launches()
    (y, wall, n_chunks), _, dev = timed(lambda: host_run(
        eng, x_np, np.random.default_rng(15), blk))
    counts = launch_counts()
    expected = walk_launches(plan, n, blk)
    canonical = plan.lengths.canonical(n)
    require(y.shape == (API_CHANNELS, canonical) and np.isfinite(y).all(),
            f"FFT-2: output {y.shape}, canonical {canonical}")
    require(counts == (expected, 0, 0),
            f"FFT-2: launches {counts}, expected ({expected}, 0, 0)")
    err = rel(y[:4], float64_run(plan, x_np[:4], 2048))
    print(f"  FFT-2 44.1k->3001 VERY_HIGH strict: prefilter {plan.aa_taps} "
          f"taps by overlap-save (N = {spec.n}, hop {spec.n - spec.taps + 1}"
          f"), one step of [{API_CHANNELS}, {blk}] {step_ms:.5f} ms on CUDA "
          f"events, kernels {sum(k[1] for k in ks):.5f} ms under the "
          f"profiler ({', '.join(k[0][:40] for k in ks[:3])}); "
          f"{API_CHANNELS} streams x {n} samples through process() in "
          f"{n_chunks} random chunks in {wall:.4f} s = "
          f"{API_CHANNELS * n / wall / 1e6:.1f} Msamples/s in (span "
          f"{dev:.3f} ms), launches (K1, K2, K3) {counts} (the prestage, "
          f"one a block: {expected}); length {y.shape[1]} == canonical "
          f"{canonical}; max |cuda f32 - cpu f64| over 4 streams = "
          f"{err:.3g} of max|y| on {card}")
    require(err <= ENGINE_TOL, f"FFT-2 vs float64: {err}")
    return counts[0]


def fft_decim_path(gen, card: str) -> int:
    """FFT-3: the FFT decimation step (``DECIM_FFT_MIN_TAPS`` lowered for
    this sub-phase only), 96k -> 48k VERY_HIGH, 256 streams x 469 blocks
    of 2048: ``process_device`` against ``process()`` at the same block
    chunks (bit for bit), both against the K1 route;
    ``TimeMajorEngine`` refuses it.  Returns K1's launches (the K1
    route's)."""
    import torch
    from go_audio_resampler_tpu_torch import (EngineCore, Quality,
                                              TimeMajorEngine, plan_engine)
    from go_audio_resampler_tpu_torch.engine import streaming

    plan = plan_engine(COMP_IN, DECIM_IN, Quality.VERY_HIGH)
    blk = 2048
    n = 469 * blk
    x = 0.5 * torch.randn((API_CHANNELS, n), generator=gen, device="cuda")
    chunks = [(a, a + blk) for a in range(0, n, blk)]
    k1 = EngineCore(plan, batch=API_CHANNELS, block=blk)
    require(k1._decim_fft is None, "FFT-3: K1 route took the FFT step")
    kchunks = [(a, min(n, a + k1.block)) for a in range(0, n, k1.block)]
    y_k1, k1_counts, k1_records = device_route(k1, x, kchunks)
    saved = streaming.DECIM_FFT_MIN_TAPS
    streaming.DECIM_FFT_MIN_TAPS = 0
    try:
        dev_eng = EngineCore(plan, batch=API_CHANNELS, block=blk)
        host = EngineCore(plan, batch=API_CHANNELS, block=blk)
        try:
            TimeMajorEngine(plan, batch=API_CHANNELS, block=blk)
            refused = ""
        except NotImplementedError as err:
            refused = str(err)
    finally:
        streaming.DECIM_FFT_MIN_TAPS = saved
    require(dev_eng._decim_fft is not None and dev_eng.block == blk
            and dev_eng.device_chunk_multiple == 2,
            f"FFT-3: block {dev_eng.block}")
    require("no banded matrix" in refused,
            f"FFT-3: TimeMajorEngine did not refuse ({refused!r})")
    y_dev, fft_counts, fft_records = device_route(dev_eng, x, chunks)
    x_np = x.cpu().numpy()
    del x
    y_host, wall_h, dev_h = timed(lambda: np.concatenate(
        [host.process(x_np[:, a:b]) for a, b in chunks] + [host.flush()],
        axis=1))
    y_dev = y_dev.cpu().numpy()
    y_k1 = y_k1.cpu().double().numpy()
    same = bool(np.array_equal(y_dev, y_host))
    err_dev, err_host = rel(y_dev, y_k1), rel(y_host, y_k1)
    rate = API_CHANNELS * n / 1e6
    print(f"  FFT-3 96k->48k VERY_HIGH ({plan.decim_taps} taps), "
          f"DECIM_FFT_MIN_TAPS lowered from {saved} to 0 for this sub-phase "
          f"only (restored: {streaming.DECIM_FFT_MIN_TAPS}): "
          f"process_device in {len(chunks)} blocks of {blk} + flush_device: "
          f"{route_line(rate * 1e6, fft_records)}; launches (K1, K2, K3) "
          f"{fft_counts}; process() in the same blocks {wall_h:.4f} s = "
          f"{rate / wall_h:.1f} Msamples/s in (span {dev_h:.3f} ms); the K1 "
          f"route in blocks of {k1.block}: "
          f"{route_line(rate * 1e6, k1_records)}; launches {k1_counts} on "
          f"{card}")
    print(f"  FFT-3: process_device equal to process() bit for bit: {same}; "
          f"against K1: {err_dev:.3g} and {err_host:.3g} of max|y|; "
          f"TimeMajorEngine refused: {refused!r}")
    require(fft_counts == (0, 0, 0) and k1_counts[1:] == (0, 0),
            f"FFT-3: launches {fft_counts}, {k1_counts}")
    require(same, "FFT-3: process_device and process() differ")
    require(err_dev <= FFT_TOL and err_host <= FFT_TOL,
            f"FFT-3 vs K1: {err_dev}, {err_host}")
    return k1_counts[0]


def api_fft_phase(gen, card: str) -> dict:
    """Phase 12: API-A to API-D, the convenience helpers and FFT-1 to
    FFT-3, each driven with the launch counts set to 0 just before it;
    returns the K1 and K3 launches by sub-path and K1's API-C record."""
    import torch
    t0 = time.perf_counter()
    out = {"api_a": api_a(gen, card)}
    torch.cuda.empty_cache()
    out["api_b"] = api_b(gen, card)
    torch.cuda.empty_cache()
    out["k1_api_c"] = api_c(gen, card)
    out["api_d"] = api_d(gen, card)
    out["conv_k1"], out["conv_k3"] = convenience_phase(gen, card)
    fft_oneshot_phase(gen, card)
    out["fft_walk"] = fft_prefilter_path(gen, card)
    torch.cuda.empty_cache()
    out["fft_decim_k1"] = fft_decim_path(gen, card)
    torch.cuda.empty_cache()
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    return out


# -- precision tiers -------------------------------------------------------


def tier_cost(tier: str, flops: int, bytes_: int) -> dict:
    """The tier's bound: its bf16 passes at 989 TFLOP/s against the bytes
    at 3.35 TB/s (R's limbs counted over its non-zeros, M's non-zeros as
    float32)."""
    t_ops = TIER_PASSES[tier] * flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = bytes_ / PEAK_HBM_BYTES * 1e3
    return {"flops_nnz": flops, "bytes": bytes_, "bound_ms": max(t_ops,
                                                                 t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes}


def rel_err(y, ref) -> tuple[float, float]:
    """(max|y - ref|, that over max|ref|)."""
    err = (y - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def tier_kernels(gen, tier: str) -> list[dict]:
    """K1, K2 and K3 at ``tier`` against their plain versions at the tier
    (TF32 off: the products are exact in both, only the sums' order
    differs), K2 == K1 bit for bit, and timed at the paths' shapes."""
    import torch
    from go_audio_resampler_tpu_torch import Quality
    from go_audio_resampler_tpu_torch.ops import banded, fused, general, tmajor

    shapes, errs = {"K1": {}, "K2": {}, "K3": {}}, {"K1": [], "K2": [],
                                                    "K3": []}
    rt, ipx, wx, p2 = operator(Quality.HIGH)
    carry = -(-(wx - ipx) // ipx) * ipx
    rt4, ipx4, wx4, p24 = decim_operator()
    for shape, (r_t, ip, w, p, s, nf, n) in {
            "main": (rt, ipx, wx, p2, STREAMS, BLOCK // ipx, carry + BLOCK),
            "decimation": (rt4, ipx4, wx4, p24, DECIM_STREAMS, 2,
                           DECIM_CARRY + 2 * ipx4)}.items():
        op = banded.prepare(r_t, tier)
        require(op.tier == tier, f"prepared at {op.tier}")
        kw = dict(ipx=ip, wx=w, p2=p, n_frames=nf, tier=tier)
        x = torch.randn((s, n), generator=gen, device="cuda")
        xt = x.t().contiguous()
        r = r_t.t().contiguous()
        y1 = fused.fused_resample(x, r_t, op=op, **kw)
        ref = fused.fused_resample_reference(x, r_t, **kw)
        y2 = tmajor.fused_resample_tmajor(xt, r, op=op, **kw)
        ref2 = tmajor.fused_resample_tmajor_reference(xt, r, **kw)
        torch.cuda.synchronize()
        e1, e2 = rel_err(y1, ref), rel_err(y2, ref2)
        same = bool(torch.equal(y2, y1.t()))
        print(f"  {tier}: K1 and K2 at the {shape} shape, data "
              f"{tuple(x.shape)}, R_t {tuple(r_t.shape)}, split {op.split}: "
              f"max |kernel - plain| = {e1[0]:.3g} ({e1[1]:.3g} of max|y|) "
              f"and {e2[0]:.3g} ({e2[1]:.3g}); K2 equal to K1 bit for bit: "
              f"{same}")
        require(e1[1] <= KERNEL_TOL and e2[1] <= KERNEL_TOL,
                f"{tier} K1/K2 {shape}: {e1}, {e2}")
        require(same, f"{tier} K2 {shape}: differs from K1")
        errs["K1"].append(e1[0])
        errs["K2"].append(e2[0])
        # Library yardstick: one bf16 matmul of the unfold view (the
        # casts are set-up, not timed); its output is bf16.
        xb, rb = x.to(torch.bfloat16), r_t.to(torch.bfloat16)
        frames = xb[:, :(nf - 1) * ip + w].unfold(1, w, ip)
        frames_t = xb.t()[:(nf - 1) * ip + w].unfold(0, w, ip).transpose(1, 2)
        rbt = r.to(torch.bfloat16)
        nnz = int(torch.count_nonzero(r_t).item())
        cost = tier_cost(tier, 2 * nnz * s * nf,
                         4 * (s * ((nf - 1) * ip + w) + s * nf * p)
                         + 2 * TIER_LIMBS[tier] * nnz)
        for k, kernel, plain, lib in (
                ("K1", lambda: fused.fused_resample(x, r_t, op=op, **kw),
                 lambda: fused.fused_resample_reference(x, r_t, **kw),
                 lambda: torch.matmul(frames, rb)),
                ("K2", lambda: tmajor.fused_resample_tmajor(xt, r, op=op,
                                                            **kw),
                 lambda: tmajor.fused_resample_tmajor_reference(xt, r, **kw),
                 lambda: torch.matmul(rbt, frames_t))):
            ms = graph_ms(kernel)
            plain_ms = graph_ms(plain, reps=5, iters=5)
            lib_ms = graph_ms(lib, reps=5, iters=5)
            print(f"  {tier}: {k} {shape} shape: kernel {ms:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, torch.matmul on bf16 operands "
                  f"{lib_ms:.5f} ms; bound {cost['bound_ms']:.5f} ms "
                  f"({cost['bound_by']}: {TIER_PASSES[tier]} bf16 passes "
                  f"{cost['bound_ops_ms']:.5f} ms, {cost['bytes']} bytes "
                  f"{cost['bound_bytes_ms']:.5f} ms); kernel at "
                  f"{cost['bound_ms'] / ms:.3f} of its bound")
            shapes[k][shape] = {"ms": ms, "plain_ms": plain_ms,
                                "library_ms": lib_ms, **cost}
        del frames, frames_t, xb

    for shape in K3_SHAPES:
        starts, m, bands, wgs = k3_operands(shape)
        n_tiles, w_band, tile = m.shape
        kw = dict(w_band=w_band, tile=tile, tier=tier)
        x = 0.5 * torch.randn((ONESHOT_STREAMS, int(starts[-1].item())
                               + w_band), generator=gen, device="cuda")
        ref = general.general_resample_reference(x, m, starts, **kw)
        for w in (wgs, 3 - wgs):
            y = general.general_resample(x, m, starts, bands=bands,
                                         warpgroups=w, **kw)
            torch.cuda.synchronize()
            e = rel_err(y, ref)
            print(f"  {tier}: K3 one-shot {shape} shape, {w} warpgroup(s) "
                  f"a block: max |kernel - plain| = {e[0]:.3g} ({e[1]:.3g} "
                  "of max|y|)")
            require(e[1] <= KERNEL_TOL, f"{tier} K3 {shape} {w}: {e}")
            errs["K3"].append(e[0])
        idx = starts[:, None] + torch.arange(w_band, device="cuda")[None, :]
        frames = x[:, idx].permute(1, 0, 2).to(torch.bfloat16).contiguous()
        mb = m.to(torch.bfloat16)
        base = k3_cost(x, m, starts, bands, wgs)
        cost = tier_cost(tier, base["flops_nnz"], base["bytes"])
        ms = graph_ms(lambda: general.general_resample(
            x, m, starts, bands=bands, warpgroups=wgs, **kw))
        plain_ms = graph_ms(lambda: general.general_resample_reference(
            x, m, starts, **kw), reps=5, iters=5)
        lib_ms = graph_ms(lambda: torch.bmm(frames, mb), reps=5, iters=5)
        print(f"  {tier}: K3 one-shot {shape} shape: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, torch.bmm on bf16 gathered frames "
              f"(gather and casts not timed) {lib_ms:.5f} ms; bound "
              f"{cost['bound_ms']:.5f} ms ({cost['bound_by']}: "
              f"{TIER_PASSES[tier]} bf16 passes {cost['bound_ops_ms']:.5f} "
              f"ms, {cost['bytes']} bytes with M's non-zeros as float32 "
              f"{cost['bound_bytes_ms']:.5f} ms); kernel at "
              f"{cost['bound_ms'] / ms:.3f} of its bound; {wgs} "
              "warpgroup(s) a block")
        shapes["K3"][shape] = {"ms": ms, "plain_ms": plain_ms,
                               "bmm_bf16_gathered_ms": lib_ms, **cost}
        del frames, mb
    torch.cuda.empty_cache()

    out = []
    for k, name, src, line, first in (
            ("K1", "fused_resample", "fused_resample.cu", 210, "main"),
            ("K2", "fused_resample_tmajor", "fused_resample_tmajor.cu", 396,
             "main"),
            ("K3", "general_resample", "general_resample.cu", 502,
             "general")):
        main = shapes[k][first]
        out.append({"name": f"{name}[{tier}]", "route": "cuda",
                    "source": f"go_audio_resampler_tpu_torch/ops/csrc/{src}",
                    "replaces": f"go_audio_resampler_tpu/ops/pallas_fused.py:"
                                f"{line}",
                    "tier": tier, "launches": None,
                    "max_abs_err": max(errs[k]), "ms": main["ms"],
                    "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    # No single PyTorch call computes K3: its nearest, bmm
                    # over gathered frames, is in shapes.
                    "library_ms": main.get("library_ms"),
                    "shapes": shapes[k]})
    return out


def tier_oneshot(x, card: str, tier: str, want=None) -> tuple[int, object]:
    """x [64, 2 s] of 44.1k -> 48.001k HIGH through ``oneshot`` with
    GAR_TPU_MATMUL_PRECISION set to ``tier``: one K3 launch, within the
    tier's bound of the float64 CPU run (``want``, computed here if None;
    returned with the K3 launches)."""
    import importlib
    import os
    import torch
    from go_audio_resampler_tpu_torch import Quality, oneshot, plan_engine
    from go_audio_resampler_tpu_torch.ops import precision
    osm = importlib.import_module("go_audio_resampler_tpu_torch.engine.oneshot")

    plan = plan_engine(RATE_IN, 48001, Quality.HIGH)
    n = x.shape[1]
    if want is None:
        want = oneshot(plan, x[:4].cpu().double().numpy(),
                       device="cpu").numpy()
    before = os.environ.get("GAR_TPU_MATMUL_PRECISION")
    os.environ["GAR_TPU_MATMUL_PRECISION"] = tier
    try:
        reset_launches()
        t0 = time.perf_counter()
        y = oneshot(plan, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        if before is None:
            del os.environ["GAR_TPU_MATMUL_PRECISION"]
        else:
            os.environ["GAR_TPU_MATMUL_PRECISION"] = before
    canonical = plan.lengths.canonical(n)
    require(tuple(y.shape) == (ONESHOT_STREAMS, canonical)
            and bool(torch.isfinite(y).all()), f"{tier} one-shot output "
            f"{tuple(y.shape)}, canonical {canonical}")
    require(counts == (0, 0, 1), f"{tier} one-shot launches {counts}")
    err = float(np.abs(y[:4].cpu().double().numpy() - want).max())
    if tier == "high":
        bound = HIGH_TOL * float(np.abs(want).max())
    else:
        _, m = osm._general_matrices(plan, canonical)
        bound = precision.default_error_bound(
            float(x.abs().max().item()), m.reshape(-1, m.shape[2]).T)
    print(f"  {tier}: one-shot 44.1k->48.001k HIGH, [{ONESHOT_STREAMS}, {n}]"
          f" -> {tuple(y.shape)} == canonical; launches K1 {counts[0]}, K3 "
          f"{counts[2]}; max |cuda f32 - cpu f64| over 4 streams = {err:.3g} "
          f"(bound {bound:.3g}); entry point {wall:.4f} s on {card}")
    require(err <= bound, f"{tier} one-shot: {err} > {bound}")
    return counts[2], want


def tier_engines(main: dict, card: str, tier: str) -> tuple[int, int]:
    """The main path's input through ``EngineCore`` (K1) and
    ``TimeMajorEngine`` (K2) at ``tier``, then the dispatch gate at the
    tier; returns (K1, K2) launches of the two runs."""
    import torch
    from go_audio_resampler_tpu_torch import (EngineCore, Quality,
                                              TimeMajorEngine, plan_engine)
    from go_audio_resampler_tpu_torch.ops import precision
    from go_audio_resampler_tpu_torch.utils import metrics

    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    x = main["x"]
    n = x.shape[1]
    canonical = plan.lengths.canonical(n)
    chunks = [(a, min(n, a + BLOCK)) for a in range(0, n, BLOCK)]
    eng = EngineCore(plan, batch=STREAMS, block=BLOCK, precision=tier)
    require(eng._tier == tier and eng._band.op.tier == tier,
            f"engine at {eng._tier}")
    expected = expected_launches(plan, n, len(chunks), eng._band.ipx,
                                 eng._band.p2, BLOCK, eng._drop)
    reset_launches()
    t0 = time.perf_counter()
    outs = [eng.process_device(x[:, a:b]) for a, b in chunks]
    outs.append(eng.flush_device())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k3 = launch_counts()
    y = torch.cat(outs, dim=1)
    require(tuple(y.shape) == (STREAMS, canonical) and k1 == expected
            and (k2, k3) == (0, 0), f"{tier} main path: {tuple(y.shape)}, "
            f"launches {k1}, {k2}, {k3} (expected {expected})")
    del outs
    tm = TimeMajorEngine(plan, batch=STREAMS, block=BLOCK, precision=tier)
    xt = x.t().contiguous()
    reset_launches()
    t1 = time.perf_counter()
    outs = [tm.process_device(xt[a:b]) for a, b in chunks]
    outs.append(tm.flush_device())
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t1
    tk1, tk2, tk3 = launch_counts()
    yt = torch.cat(outs)
    del outs, xt
    require(tk2 == expected and (tk1, tk3) == (0, 0),
            f"{tier} time-major launches {tk1}, {tk2}, {tk3}")
    same = bool(torch.equal(yt.t(), y))
    del yt
    require(bool(torch.isfinite(y).all()), f"{tier}: non-finite output")
    got = y[:4].cpu().double().numpy()
    err = float(np.abs(got - main["want"]).max())
    if tier == "high":
        bound = HIGH_TOL * float(np.abs(main["want"]).max())
    else:
        bound = precision.default_error_bound(
            float(x[:4].abs().max().item()), eng._band.r_t)
    thd = metrics.thd(got[0], RATE_OUT, 1000.0, 16384)
    print(f"  {tier}: main path {STREAMS} streams x {n} samples: EngineCore "
          f"{STREAMS * n / wall / 1e6:.1f} Msamples/s in ({k1} K1 launches),"
          f" TimeMajorEngine {STREAMS * n / wall_t / 1e6:.1f} Msamples/s in "
          f"({tk2} K2 launches) on {card}")
    print(f"  {tier}: length {y.shape[1]} == canonical {canonical}; "
          f"time-major equal to stream-major bit for bit: {same}; max |cuda "
          f"f32 - cpu f64| over 4 streams = {err:.3g} (bound {bound:.3g}); "
          f"THD of the 1 kHz stream = {thd:.2f} dB (pin "
          f"{TIER_THD_DB[tier]} dB)")
    require(same, f"{tier}: time-major differs from stream-major")
    require(err <= bound, f"{tier}: {err} > {bound}")
    require(thd <= TIER_THD_DB[tier], f"{tier}: THD {thd} dB")

    # The gate, on 64 streams x 20 blocks.
    xs = x[:64, :20 * BLOCK]
    runs = {}
    for mode in ("auto", "pallas", "xla", "force_xla"):
        kw = dict(batch=64, block=BLOCK, precision=tier,
                  dispatch="auto" if mode == "force_xla" else mode)
        core, tme = EngineCore(plan, **kw), TimeMajorEngine(plan, **kw)
        reset_launches()
        with (precision.force_xla() if mode == "force_xla"
              else contextlib.nullcontext()):
            ys = torch.cat([core.process_device(xs), core.flush_device()], 1)
            yts = torch.cat([tme.process_device(xs.t().contiguous()),
                             tme.flush_device()])
        torch.cuda.synchronize()
        runs[mode] = (ys, yts, launch_counts())
    gate = {m: c for m, (_, _, c) in runs.items()}
    print(f"  {tier}: gate launches (K1, K2, K3) by mode: {gate}")
    require(all(c[0] > 0 and c[1] > 0 for m, c in gate.items()
                if m in ("auto", "pallas")), f"{tier}: gate {gate}")
    require(gate["xla"] == gate["force_xla"] == (0, 0, 0),
            f"{tier}: gate {gate}")
    require(torch.equal(runs["xla"][0], runs["force_xla"][0])
            and torch.equal(runs["xla"][1], runs["force_xla"][1])
            and torch.equal(runs["auto"][0], runs["pallas"][0])
            and torch.equal(runs["auto"][1], runs["pallas"][1]),
            f"{tier}: modes of one route differ")
    e = rel_err(runs["auto"][0], runs["xla"][0])
    print(f"  {tier}: 'xla' == force_xla and 'auto' == 'pallas' bit for "
          f"bit; max |kernel - plain| over the run = {e[0]:.3g} ({e[1]:.3g}"
          " of max|y|)")
    require(e[1] <= KERNEL_TOL, f"{tier}: engine kernel vs plain {e}")
    return k1, tk2


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
    decimation paths (the last through both engines): host enqueue time,
    device time, and the device time of each kernel from
    ``torch.profiler``."""
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
        ("time-major decimation path", TimeMajorEngine(
            decim, batch=DECIM_STREAMS, block=2048), DECIM_STREAMS, 3072,
         True),
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


# -- variable rate, checkpoints, functional and shims (phase 13) -------------

#: VR (drift correction): 256 streams of 235 blocks of 2048 samples at 48
#: kHz (10.03 s), the clock at 48000/47990, slewed to 48000/48010 over 48000
#: outputs from block 117 on; max_ratio 2.0.  Stream 0 is a 0.2 fs tone:
#: 'vr-hq' must cut its residual by 20 dB against 'vr' before the slew
#: (tests/test_variable_rate.py:137-149).
VR_IN, VR_STREAMS, VR_BLOCK, VR_BLOCKS, VR_MID = 48000, 256, 2048, 235, 117
VR_MAX, VR_RATIO = 2.0, 48000 / 47990
VR_SLEW_TO, VR_SLEW_LEN = 48000 / 48010, 48000
VR_TONE, VR_HQ_GAIN_DB = 0.2, 20.0
#: blocks a process_device call
VR_CHUNK_BLOCKS = 8
#: Functional (training ingest): 64 streams of 2 s; the adjoint identity
#: is held to 1e-5 of |y| |w| (float32 products).
FUNC_STREAMS, FUNC_SECONDS, ADJOINT_TOL = 64, 2, 1e-5


def k1_at(label: str, x, r_t, ipx: int, p2: int, nf: int, op,
          library: dict | None = None, *, head=None,
          width: int | None = None) -> dict:
    """K1 at one shape (``x`` [S, n] against R_t [wx, p2], ``nf`` frames,
    read as ``fused_resample`` reads it: behind ``head`` and out to
    ``width``) against its plain version within 2e-5 of max|y|, then timed
    beside it and ``library`` (by default ``F.conv1d`` over R's columns at
    stride ipx, on the virtual rows materialised), with its bounds; the
    record for the kernels' line."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch.ops import fused

    wx = r_t.shape[0]
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=nf, tier="highest", head=head,
              width=width)
    y = fused.fused_resample(x, r_t, op=op, **kw)
    ref = fused.fused_resample_reference(x, r_t, **kw)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item() / ref.abs().max().item()
    c = fused._head_width(head)
    print(f"  K1 {label}: data {tuple(x.shape)}, head {c}, width "
          f"{width}, R_t {(wx, p2)}, {nf} frames, ipx {ipx}, split "
          f"{op.split}: max |kernel - plain| = {err:.3g} of max|y|")
    require(tuple(y.shape) == (x.shape[0], nf * p2) and err <= KERNEL_TOL,
            f"K1 {label}: {tuple(y.shape)}, error {err}")
    if library is None:
        weight = r_t.t().contiguous()[:, None, :]
        rows = fused.virtual_row(x, head, width)
        lib_in = rows[:, None, :(nf - 1) * ipx + wx].contiguous()
        library = {"library_conv1d_ms":
                   lambda: F.conv1d(lib_in, weight, stride=ipx)}
    timed = time_banded(
        f"K1 {label} shape", lambda: fused.fused_resample(x, r_t, op=op, **kw),
        lambda: fused.fused_resample_reference(x, r_t, **kw), library,
        banded_cost(r_t, op, x.shape[0] * nf,
                    x.shape[0] * ((nf - 1) * ipx + wx)))
    return {**timed, "max_abs_err": err}


def prestage_k1(label: str, band, coeffs, xext) -> dict:
    """K1 at a 2x prestage's shape (the banded convolution of ``xext``
    with the prepared ``band``), with ``F.conv1d`` of the phase rows
    (stride 1, F = 2) as its library call."""
    import torch.nn.functional as F
    wx, p2 = band.r_t.shape
    t1 = coeffs.shape[1]
    nf = -(-(xext.shape[1] - t1 + 1) // band.p)
    weight = coeffs[:, None, :].contiguous()
    lib_in = xext[:, None, :]
    return k1_at(label, xext, band.r_t, band.p, p2, nf, band.op,
                 {"library_conv1d_ms": lambda: F.conv1d(lib_in, weight)})


def vr_route(vr, route: str, x_np, x_dev, rng) -> dict:
    """One run of the VR stream: ``route`` 'device' feeds
    ``process_device`` VR_CHUNK_BLOCKS blocks a call, 'host' feeds
    ``process()`` random chunks of 1 to 3 blocks' samples (``rng``); the
    slew is set after block VR_MID; then the flush.  Returns the output
    (host), the outputs before the slew, the wall time (s) and the host
    time of the ``process_device`` calls (s)."""
    import torch
    blk, n = vr.block, x_np.shape[1]
    outs, enqueue, before = [], 0.0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, hi in ((0, VR_MID * blk), (VR_MID * blk, n)):
        if lo:
            before = vr.samples_out
            vr.set_io_ratio(VR_SLEW_TO, slew_len=VR_SLEW_LEN)
        a = lo
        while a < hi:
            if route == "device":
                b = min(hi, a + VR_CHUNK_BLOCKS * blk)
                t = time.perf_counter()
                outs.append(vr.process_device(x_dev[:, a:b]))
                enqueue += time.perf_counter() - t
            else:
                b = min(hi, a + int(rng.integers(1, 3 * blk + 1)))
                outs.append(vr.process(x_np[:, a:b]))
            a = b
    if route == "device":
        outs.append(vr.flush_device())
        y = torch.cat(outs, dim=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        y = y.cpu().numpy()
    else:
        outs.append(vr.flush())
        y = np.concatenate(outs, axis=1)
        wall = time.perf_counter() - t0
    return {"y": y, "before": before, "wall": wall, "enqueue": enqueue}


def vr_launches(vr, n: int) -> int:
    """K1 launches of a 'vr-hq' run of ``n`` samples (whole blocks), then
    flushed: one a block, and the flush's zero blocks, which cover the
    prestage delay plus the cubic lookahead (VariableRateResampler.flush);
    none for 'vr'."""
    if vr.factor == 1:
        return 0
    return n // vr.block + -(-(vr._delay_u + 3) // (vr.factor * vr.block))


def tone_residual(y: np.ndarray, f: float) -> float:
    """RMS residual of ``y`` after a least-squares fit of a tone of ``f``
    cycles per sample, 500 samples trimmed at each end."""
    y = y[500:-500]
    t = np.arange(y.size) + 500.0
    a = np.stack([np.cos(2 * np.pi * f * t), np.sin(2 * np.pi * f * t)], 1)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return float(np.sqrt(np.mean((y - a @ coef) ** 2)))


def vr_step_times(vr, x_dev, card: str, steps: int = 20) -> None:
    """Warm steps of one resampler through ``process_device`` (the host
    walk included): host enqueue, device span and kernels busy per block
    (``torch.profiler``)."""
    import torch
    chunk = x_dev[:, :steps * vr.block]
    vr.process_device(chunk)
    _, wall, span = timed(lambda: vr.process_device(chunk))
    t0 = time.perf_counter()
    vr.process_device(chunk)
    enqueue = (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.synchronize()
    kernels = device_kernels(lambda: vr.process_device(chunk), 1)
    busy = sum(ms for _, ms, _ in kernels) / steps
    k1 = sum(ms for name, ms, _ in kernels
             if "fused_resample_kernel" in name) / steps
    count = sum(c for _, _, c in kernels) / steps
    print(f"  VR {vr.quality} steps: host enqueue {enqueue:.5f} ms/block, "
          f"wall {wall / steps * 1e3:.5f} ms/block, device span "
          f"{span / steps:.5f} ms/block, kernels busy {busy:.5f} ms/block "
          f"(K1 {k1:.5f}) in {count:g} launches a block (torch.profiler; "
          f"device idle share {max(0.0, 1 - busy / (wall / steps * 1e3)):.3f})"
          f" on {card}")


def vr_phase(gen, card: str) -> dict:
    """VR drift correction, 'vr' and 'vr-hq', each through ``process()``
    in two random chunkings and through ``process_device``: equal bit for
    bit, 4 streams against the float64 CPU run, K1 launches, the 0.2 fs
    tone's residual; K1 at the prestage's shape.  Returns K1's record
    there and the 'vr-hq' device run (the checkpoint phase resumes it)."""
    import torch
    from go_audio_resampler_tpu_torch import VariableRateResampler
    from go_audio_resampler_tpu_torch.utils import signals

    n = VR_BLOCKS * VR_BLOCK
    x_dev = 0.5 * torch.randn((VR_STREAMS, n), generator=gen, device="cuda")
    x_dev[0] = torch.sin(2 * np.pi * VR_TONE * torch.arange(
        n, dtype=torch.float64, device="cuda")).float()
    x_dev[1] = torch.as_tensor(signals.sine(n, 1000.0, VR_IN),
                               dtype=torch.float32, device="cuda")
    x_np = x_dev.cpu().numpy()
    out, resid = {}, {}

    def make(quality, **kw):
        kw.setdefault("batch", VR_STREAMS)
        return VariableRateResampler(VR_MAX, VR_RATIO, block=VR_BLOCK,
                                     quality=quality, **kw)

    for quality in ("vr", "vr-hq"):
        runs = {}
        for name, route, seed in (("process", "host", 1),
                                  ("process, other chunks", "host", 2),
                                  ("process_device", "device", 0)):
            vr = make(quality)
            reset_launches()
            runs[name] = vr_route(vr, route, x_np, x_dev,
                                  np.random.default_rng(seed))
            runs[name]["launches"] = launch_counts()
            runs[name]["stats"] = vr.get_statistics()
        want = vr_launches(vr, n)
        ref = make(quality, batch=4, dtype=np.float64, device="cpu")
        y64 = vr_route(ref, "host", x_np[:4].astype(np.float64), None,
                       np.random.default_rng(3))["y"]
        y = runs["process"]["y"]
        err = rel(y[:4], y64)
        same_dev = np.array_equal(runs["process_device"]["y"], y)
        same_chunks = np.array_equal(runs["process, other chunks"]["y"], y)
        resid[quality] = tone_residual(
            y[0, :runs["process"]["before"]].astype(np.float64),
            VR_TONE * VR_RATIO)
        for name, r in runs.items():
            blocks = VR_BLOCKS + 1
            enqueue = (f", host enqueue {r['enqueue'] / blocks * 1e3:.4f} ms "
                       "a block" if r["enqueue"] else "")
            print(f"  VR {quality} {name}: {VR_STREAMS} x {n} samples -> "
                  f"{r['y'].shape[1]} in {r['wall']:.4f} s = "
                  f"{VR_STREAMS * n / r['wall'] / 1e6:.1f} Msamples/s in "
                  f"({r['wall'] / blocks * 1e3:.4f} ms a block{enqueue}); "
                  f"launches (K1, K2, K3) {r['launches']}; {r['stats']} on "
                  f"{card}")
        print(f"  VR {quality}: process_device == process() bit for bit: "
              f"{same_dev}; two chunkings equal bit for bit: {same_chunks}; "
              f"max |cuda f32 - cpu f64| over 4 streams = {err:.3g} of "
              f"max|y|; 0.2 fs tone residual {resid[quality]:.4g} before "
              f"the slew; K1 launches derived {want}")
        require(same_dev and same_chunks, f"VR {quality}: routes differ")
        require(all(r["launches"] == (want, 0, 0) for r in runs.values()),
                f"VR {quality}: launches {[r['launches'] for r in runs.values()]}"
                f" (expected {want})")
        require(y[:4].shape == y64.shape and np.isfinite(y).all()
                and err <= ENGINE_TOL, f"VR {quality} vs float64: {err}")
        require(all(r["stats"] == runs["process"]["stats"]
                    for r in runs.values()), f"VR {quality}: statistics")
        vr_step_times(make(quality), x_dev, card)
        out[quality] = runs["process_device"]["y"]
    gain = 20 * np.log10(resid["vr"] / resid["vr-hq"])
    print(f"  VR: 'vr-hq' cuts the 0.2 fs tone's residual by {gain:.2f} dB "
          f"against 'vr' (floor {VR_HQ_GAIN_DB} dB)")
    require(gain >= VR_HQ_GAIN_DB, f"VR-hq gain {gain} dB")
    vr = make("vr-hq")
    xext = torch.cat([torch.zeros((VR_STREAMS, vr._pre_t1 - 1),
                                  device="cuda"), x_dev[:, :VR_BLOCK]], 1)
    record = prestage_k1("VR prestage", vr._pre_band, vr._pre_coeffs, xext)
    record["launches"] = vr_launches(vr, n)
    return {"k1": record, "x": x_dev, "y_hq": out["vr-hq"]}


def resume_check(label: str, make, feed, flush, save, load, chunks, cut,
                 path) -> None:
    """A stream run whole, and run again with a snapshot after ``cut``
    chunks restored into a fresh object that goes on: the two outputs
    must be equal bit for bit.  ``feed(obj, chunk)`` and ``flush(obj)``
    return tensors on the card."""
    import torch
    a = make()
    whole = torch.cat([feed(a, c) for c in chunks] + [flush(a)], dim=1)
    b = make()
    outs = [feed(b, c) for c in chunks[:cut]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save(b, path)
    t1 = time.perf_counter()
    c = make()
    t2 = time.perf_counter()
    load(c, path)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    outs += [feed(c, ch) for ch in chunks[cut:]] + [flush(c)]
    same = bool(torch.equal(torch.cat(outs, dim=1), whole))
    print(f"  checkpoint {label}: saved after {cut} of {len(chunks)} chunks "
          f"({pathlib.Path(path).stat().st_size} bytes), save "
          f"{(t1 - t0) * 1e3:.3f} ms, load {(t3 - t2) * 1e3:.3f} ms; the "
          f"resumed stream equals the whole run bit for bit: {same}")
    require(same, f"checkpoint {label}: the resumed stream differs")


def checkpoint_phase(gen, card: str, vr_run: dict) -> None:
    """Save mid-stream and resume in a fresh object, on the card: the main
    path's ``EngineCore``, the 96k -> 44.1k composite inside its head
    region, an API-A ``Resampler`` and the VR mid-slew."""
    import tempfile
    import torch
    import go_audio_resampler_tpu_torch as gar
    from go_audio_resampler_tpu_torch.engine import checkpoint as ck

    def engine_feed(eng, ch):
        return eng.process_device(ch)

    def engine_flush(eng):
        return eng.flush_device()

    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "state.npz"
        plan = gar.plan_engine(RATE_IN, RATE_OUT, gar.Quality.HIGH)
        n = RATE_IN * SECONDS
        x = 0.5 * torch.randn((STREAMS, n), generator=gen, device="cuda")
        chunks = [x[:, a:a + BLOCK] for a in range(0, n, BLOCK)]
        resume_check("main path (EngineCore, 1024 x 10 s)",
                     lambda: gar.EngineCore(plan, batch=STREAMS,
                                            block=BLOCK),
                     engine_feed, engine_flush, ck.save_stream_state,
                     ck.load_stream_state, chunks, len(chunks) // 2, path)
        del x, chunks
        comp = composite_plan(((24000, False), (44100, True)))
        n = COMP_IN * SECONDS
        x = 0.5 * torch.randn((COMP_STREAMS, n), generator=gen,
                              device="cuda")
        probe = gar.EngineCore(comp, batch=COMP_STREAMS, block=2048)
        blk = probe.block
        probe.process_device(x[:, :blk])
        require(0 == probe.samples_out < comp.op.n_head
                and probe._head_have > 0,
                f"composite: {probe.samples_out} outputs after one block")
        chunks = [x[:, a:a + blk] for a in range(0, n - n % blk, blk)]
        resume_check("96k->44.1k composite inside its head region "
                     f"({COMP_STREAMS} x 10 s; 0 of {comp.op.n_head} head "
                     "outputs emitted)",
                     lambda: gar.EngineCore(comp, batch=COMP_STREAMS,
                                            block=2048),
                     engine_feed, engine_flush, ck.save_stream_state,
                     ck.load_stream_state, chunks, 1, path)
        del x, chunks, probe
        n = RATE_IN * SECONDS
        x = api_input(gen, RATE_IN, n)
        chunks = [x[:, a:a + BLOCK] for a in range(0, n, BLOCK)]
        resume_check(f"API-A Resampler ({API_CHANNELS} x 10 s)",
                     lambda: api_resampler(RATE_IN, RATE_OUT, 3,
                                           channels=API_CHANNELS,
                                           dtype=np.float32,
                                           max_input_size=BLOCK),
                     lambda r, ch: r.process_multi_device(ch),
                     lambda r: r.flush_multi_device(),
                     ck.save_resampler_state, ck.load_resampler_state,
                     chunks, len(chunks) // 2, path)
        del x, chunks
        # The VR mid-slew: the 'vr-hq' device run of the VR phase, resumed
        # from a snapshot taken a chunk after the slew was set.
        vr_x = vr_run["x"]
        blk = VR_BLOCK * VR_CHUNK_BLOCKS
        mid = VR_MID * VR_BLOCK
        bounds = ([(a, min(mid, a + blk)) for a in range(0, mid, blk)]
                  + [(a, min(vr_x.shape[1], a + blk))
                     for a in range(mid, vr_x.shape[1], blk)])
        cut = sum(1 for a, _ in bounds if a < mid) + 1

        def make_vr():
            return gar.VariableRateResampler(VR_MAX, VR_RATIO,
                                             batch=VR_STREAMS,
                                             block=VR_BLOCK,
                                             quality="vr-hq")
        vr = make_vr()
        outs = []
        for i, (a, b) in enumerate(bounds[:cut]):
            if a == mid:
                vr.set_io_ratio(VR_SLEW_TO, slew_len=VR_SLEW_LEN)
            outs.append(vr.process_device(vr_x[:, a:b]))
        slewing = vr.get_statistics()["slewRemaining"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_vr_state(vr, path)
        t1 = time.perf_counter()
        fresh = make_vr()
        t2 = time.perf_counter()
        ck.load_vr_state(fresh, path)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        outs += [fresh.process_device(vr_x[:, a:b]) for a, b in bounds[cut:]]
        outs.append(fresh.flush_device())
        got = torch.cat(outs, dim=1).cpu().numpy()
        same = np.array_equal(got, vr_run["y_hq"])
        print(f"  checkpoint VR 'vr-hq' mid-slew ({slewing} slew outputs to "
              f"go; {VR_STREAMS} x {vr_x.shape[1]}): save "
              f"{(t1 - t0) * 1e3:.3f} ms, load {(t3 - t2) * 1e3:.3f} ms; "
              f"the resumed stream equals the VR phase's device run bit for "
              f"bit: {same} on {card}")
        require(slewing > 0 and same, "checkpoint VR: the resumed stream "
                f"differs (slew remaining {slewing})")


def functional_phase(gen, card: str, general) -> dict:
    """``functional.resample`` on 64 streams x 2 s: 48k -> 16k and 44.1k
    -> 48k (the one-shot's operator: bit for bit ``oneshot``, one K1
    launch) and 44.1k -> 48.001k (the block loop: one K1 launch a block,
    within 2e-5 of max|y| of the one-shot phase's K3 output); the adjoint
    identity, no launch in the backward; a few optimizer steps of a
    learnable front end; K1 at the new shapes.  Returns their records."""
    import torch
    from go_audio_resampler_tpu_torch import functional, oneshot
    from go_audio_resampler_tpu_torch.engine.oneshot import _pad

    records = {}
    for rate_in, rate_out in ((DECIM_IN, DECIM_OUT), (RATE_IN, RATE_OUT),
                              (RATE_IN, WALK_OUT)):
        label = f"{rate_in / 1000:g}k->{rate_out / 1000:g}k"
        plan = functional._plan(float(rate_in), float(rate_out),
                                functional.QualityPreset.HIGH)
        scan = functional._needs_length_matrices(plan)
        n = FUNC_SECONDS * rate_in
        if scan:
            x, ref = general
            require(tuple(x.shape) == (FUNC_STREAMS, n), "general input")
        else:
            x = 0.5 * torch.randn((FUNC_STREAMS, n), generator=gen,
                                  device="cuda")
            ref = oneshot(plan, x)
        functional.resample(x, rate_in, rate_out)          # warm
        reset_launches()
        y, wall, fwd_ms = timed(lambda: functional.resample(x, rate_in,
                                                            rate_out))
        counts = launch_counts()
        if scan:
            block, _cap, hold, _banks, pre, band = functional._walk_constants(
                plan, torch.float32, x.device, "highest")
            want = (-(-(n + plan.lengths.flush_pad(n) + hold) // block), 0, 0)
            err = rel(y.cpu().numpy(), ref.cpu().double().numpy())
            ok = err <= ENGINE_TOL
            what = f"within {err:.3g} of max|y| of the one-shot (K3)"
        else:
            want = (1, 0, 0)
            ok = bool(torch.equal(y, ref))
            what = f"equal to oneshot bit for bit: {ok}"
        xr = x.clone().requires_grad_()
        yr = functional.resample(xr, rate_in, rate_out)
        w = torch.randn(yr.shape, generator=gen, device="cuda")
        torch.autograd.grad(yr, xr, w, retain_graph=True)  # warm
        reset_launches()
        (xbar,), _, bwd_ms = timed(lambda: torch.autograd.grad(
            yr, xr, w, retain_graph=True))
        bwd_counts = launch_counts()
        lhs = float((yr.detach().double() * w.double()).sum())
        rhs = float((x.double() * xbar.double()).sum())
        scale = float(yr.detach().double().norm() * w.double().norm())
        route = "block loop" if scan else "one-shot operator"
        print(f"  functional {label} ({route}): "
              f"[{FUNC_STREAMS}, {n}] -> {tuple(y.shape)}, {what}; "
              f"forward {fwd_ms:.4f} ms, launches {counts} (expected {want}); "
              f"backward {bwd_ms:.4f} ms, launches {bwd_counts}; <Rx, w> = "
              f"{lhs:.9g}, <x, R^T w> = {rhs:.9g} (|diff| {abs(lhs - rhs):.3g},"
              f" {abs(lhs - rhs) / scale:.3g} of |y| |w|) on {card}")
        require(ok and counts == want, f"functional {label}: {what}, "
                f"launches {counts}")
        require(bwd_counts == (0, 0, 0), f"functional {label}: the backward "
                f"launched {bwd_counts}")
        require(abs(lhs - rhs) <= ADJOINT_TOL * scale,
                f"functional {label}: adjoint {lhs} vs {rhs}")
        if scan:
            xext = _pad(x[:, :block], plan.pre_taps - 1, 0)
            rec = prestage_k1(f"functional {label} prestage", band, pre,
                              xext)
            rec["launches"] = counts[0]
            records["functional_scan_prestage"] = rec
        elif rate_out == DECIM_OUT:
            r_t, ipx, op, _lam = functional._aux(plan, n, torch.float32,
                                                 x.device, "highest")
            wx, p2 = r_t.shape
            nf = -(-plan.lengths.canonical(n) // p2)
            need = (nf - 1) * ipx + wx
            xs = _pad(x, 0, max(plan.lengths.flush_pad(n), need - n))
            taps = torch.as_tensor(plan.decim_coeffs, dtype=torch.float32,
                                   device="cuda")[None, None, :]
            lib_in = xs[:, None, :]
            rec = k1_at(f"functional {label}", x, r_t, ipx, p2, nf, op,
                        {"library_conv1d_ms": lambda: torch.nn.functional.
                         conv1d(lib_in, taps, stride=plan.factor)},
                        width=need)
            rec["launches"] = counts[0]
            records["functional_48k_16k"] = rec
    # Training ingest: a learnable front end before 48k -> 16k.
    torch.manual_seed(0)
    x = torch.randn((FUNC_STREAMS, 1, FUNC_SECONDS * DECIM_IN),
                    generator=gen, device="cuda")
    target = functional.resample(torch.tanh(0.7 * x[:, 0]), DECIM_IN,
                                 DECIM_OUT)
    front = torch.nn.Conv1d(1, 1, 9, padding=4).cuda()
    opt = torch.optim.Adam(front.parameters(), lr=0.05)
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        y = functional.resample(torch.tanh(front(x)[:, 0]), DECIM_IN,
                                DECIM_OUT)
        loss = ((y - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"  functional training: 5 Adam steps of a Conv1d front end "
          f"through 48k->16k on [{FUNC_STREAMS}, {x.shape[2]}]: loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}, {step_ms:.3f} ms a step on "
          f"{card}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"functional training: losses {losses}")
    return records


def shims_phase(gen, card: str) -> dict:
    """``soxr_compat.resample`` on 2 channels x 10 s (44.1k -> 48k HQ) and
    ``torch_compat.Resample`` (48k -> 44.1k) on a [64, 96000] tensor on the
    card, each equal bit for bit to ``oneshot`` on its plan, one K1 launch
    each; K1 at both shapes.  Returns their records."""
    import importlib
    import torch
    from go_audio_resampler_tpu_torch import (Quality, oneshot, plan_engine,
                                              soxr_compat, torch_compat)
    osm = importlib.import_module("go_audio_resampler_tpu_torch.engine.oneshot")

    def k1_of(label, plan, x):
        r_t, ipx, op, lam = osm._oneshot_aux(plan, x.shape[1], torch.float32,
                                             x.device, "highest")
        wx, p2 = r_t.shape
        nf = -(-plan.lengths.canonical(x.shape[1]) // p2)
        return k1_at(label, x, r_t, ipx, p2, nf, op, head=lam or None,
                     width=(nf - 1) * ipx + wx)

    records = {}
    n = RATE_IN * SECONDS
    frames = (0.5 * torch.randn((2, n), generator=gen, device="cuda")).cpu(
        ).numpy().T.copy()
    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    reset_launches()
    y, wall, _ = timed(lambda: soxr_compat.resample(frames, RATE_IN,
                                                    RATE_OUT, "HQ"))
    counts = launch_counts()
    ref = oneshot(plan, frames.T.copy()).cpu().numpy().T
    same = np.array_equal(y, ref) and y.dtype == np.float32
    print(f"  soxr_compat.resample: {frames.shape} -> {y.shape} in "
          f"{wall * 1e3:.3f} ms (numpy in and out), launches {counts}; "
          f"equal to oneshot bit for bit: {same} on {card}")
    require(same and counts == (1, 0, 0), f"soxr_compat: {same}, {counts}")
    rec = k1_of("soxr 2 ch x 10 s", plan, torch.from_numpy(
        frames.T.copy()).cuda())
    records["soxr_2ch"] = {**rec, "launches": counts[0]}
    x = 0.5 * torch.randn((FUNC_STREAMS, FUNC_SECONDS * DECIM_IN),
                          generator=gen, device="cuda")
    t = torch_compat.Resample(DECIM_IN, RATE_IN)
    reset_launches()
    y, wall, span = timed(lambda: t(x))
    counts = launch_counts()
    _, warm, warm_span = timed(lambda: t(x))
    plan = plan_engine(DECIM_IN, RATE_IN, Quality.HIGH)
    ref = oneshot(plan, x)
    same = bool(torch.equal(y, ref[:, :y.shape[1]]))
    n_out = -(-x.shape[1] * RATE_IN // DECIM_IN)
    print(f"  torch_compat.Resample: {tuple(x.shape)} on {x.device} -> "
          f"{tuple(y.shape)} {y.dtype} on {y.device} in {wall * 1e3:.3f} ms "
          f"the first call (the operator's host design included; device "
          f"span {span:.3f} ms), {warm * 1e3:.3f} ms the next (span "
          f"{warm_span:.3f} ms), launches {counts}; equal to oneshot bit for "
          f"bit: {same} on {card}")
    require(same and counts == (1, 0, 0) and y.device == x.device
            and tuple(y.shape) == (FUNC_STREAMS, n_out),
            f"torch_compat: {same}, {counts}, {tuple(y.shape)}")
    rec = k1_of("torch_compat [64, 96000]", plan, x)
    records["torch_compat_48k_44k"] = {**rec, "launches": counts[0]}
    return records


def phase13(gen, card: str, general) -> dict:
    """Phase 13: the variable-rate resampler, checkpoints, the functional
    op and the shims; returns the K1 records of its shapes."""
    import torch
    t0 = time.perf_counter()
    vr = vr_phase(gen, card)
    shapes = {"vr_prestage": vr["k1"]}
    torch.cuda.empty_cache()
    checkpoint_phase(gen, card, vr)
    del vr
    torch.cuda.empty_cache()
    shapes.update(functional_phase(gen, card, general))
    shapes.update(shims_phase(gen, card))
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s")
    return shapes


# -- sharding, the CLI, the quality tool and the roofline (phase 14) ---------

#: Sharded walk: 44.1k -> 48.001k HIGH, 256 streams; 20 steps a sharded
#: stream step.
SHARD_WALK_STREAMS, SHARD_STEPS = 256, 20
#: CLI: a 5-minute stereo 24-bit 44.1 kHz file (a 1 kHz tone and noise)
#: to 48 kHz HIGH; batch mode, 32 stereo 16-bit files of 5 to 60 s.
CLI_SECONDS, CLI_FILES, CLI_THD_DB = 300, 32, -130.0


def local(y):
    """A ``DTensor``'s local shard, or ``y`` itself."""
    from torch.distributed.tensor import DTensor
    return y.to_local() if isinstance(y, DTensor) else y


def is_row_sharded(y) -> bool:
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(y, DTensor) and y.placements == (Shard(0),)


class Calls(list):
    """The recorded ``(args, kwargs)`` of a kernel's calls, one a shape;
    ``total`` counts every call."""
    total = 0


@contextlib.contextmanager
def kernel_calls(module, name: str):
    """Records the arguments of the first call of each shape that the
    block makes to ``module.name`` (the launch counter counts every call
    as before), so that the kernel can be timed at the shapes a path
    really gave it."""
    calls, seen, real = Calls(), set(), getattr(module, name)

    def spy(*args, **kw):
        calls.total += 1
        key = (tuple(tuple(a.shape) for a in args),
               tuple((k, v) for k, v in kw.items() if isinstance(v, int)))
        if key not in seen:
            seen.add(key)
            calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def k1_calls():
    from go_audio_resampler_tpu_torch.ops import fused
    return kernel_calls(fused, "fused_resample")


def k3_calls():
    from go_audio_resampler_tpu_torch.ops import general
    return kernel_calls(general, "general_resample")


def k1_at_call(label: str, call) -> dict:
    """K1 at a recorded call (``k1_at``), as the call made it."""
    (data, r_t), kw = call
    return k1_at(label, data, r_t, kw["ipx"], kw["p2"], kw["n_frames"],
                 kw["op"], head=kw.get("head"), width=kw.get("width"))


def k3_at_call(label: str, call) -> dict:
    """K3 at a recorded call's shape: against its plain version within
    2e-5 of max|y|, then timed (``k3_at``)."""
    import torch
    from go_audio_resampler_tpu_torch.ops import general
    (x, m, starts), kw = call
    shape = dict(w_band=kw["w_band"], tile=kw["tile"], tier="highest")
    y = general.general_resample(x, m, starts, bands=kw["bands"],
                                 warpgroups=kw["warpgroups"], **shape)
    ref = general.general_resample_reference(x, m, starts, **shape)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item() / ref.abs().max().item()
    print(f"  K3 {label}: x {tuple(x.shape)}, M {tuple(m.shape)}: max "
          f"|kernel - plain| = {err:.3g} of max|y|")
    require(err <= KERNEL_TOL, f"K3 {label}: error {err}")
    return {**k3_at(label, x, m, starts, kw["bands"], kw["warpgroups"]),
            "max_abs_err": err}


def sharded_main(gen, card: str, mesh) -> dict:
    """The main path through ``ShardedEngineCore`` at world size 1 beside
    the serial ``EngineCore``: a serial and a sharded run compared bit
    for bit (the first pays the allocator's growth), then warm runs in
    turns (sharded, serial, serial, sharded) for Msamples/s in and host
    enqueue a step; 190 K1 launches and ``DTensor`` outputs in each."""
    import torch
    from go_audio_resampler_tpu_torch import (EngineCore, Quality, parallel,
                                              plan_engine)

    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    n = RATE_IN * SECONDS
    x = torch.empty((STREAMS, n), device="cuda").normal_(generator=gen)
    x *= 0.5
    chunks = [(a, min(n, a + BLOCK)) for a in range(0, n, BLOCK)]
    runs = {}
    for name in ("serial", "sharded", "sharded, warm 1", "serial, warm 1",
                 "serial, warm 2", "sharded, warm 2"):
        if name.startswith("sharded"):
            eng = parallel.ShardedEngineCore(plan, mesh,
                                             batch_per_device=STREAMS,
                                             block=BLOCK)
        else:
            eng = EngineCore(plan, batch=STREAMS, block=BLOCK)
        reset_launches()
        with (k1_calls() if name == "sharded"
              else contextlib.nullcontext(Calls())) as calls:
            outs, st = timed_run(eng, lambda a, b: x[:, a:b], chunks)
        st["launches"] = launch_counts()
        if calls:
            k1_call = calls[0]
        st["dtensors"] = all(is_row_sharded(o) for o in outs)
        st["state_rows"] = eng.state.shape[0]
        if "warm" not in name:
            st["y"] = torch.cat([local(o) for o in outs], dim=1)
        del outs, eng
        runs[name] = st
        print(f"  {name}: {STREAMS} x {n} samples in {st['wall']:.4f} s = "
              f"{STREAMS * n / st['wall'] / 1e6:.1f} Msamples/s in; "
              f"launches (K1, K2, K3) {st['launches']}; {run_stats(st)} on "
              f"{card}")
    same = torch.equal(runs["sharded"]["y"], runs["serial"]["y"])
    canonical = plan.lengths.canonical(n)
    enq = {k: float(np.median(v["steps_ms"])) for k, v in runs.items()}
    warm = {e: [k for k in runs if k.startswith(e) and "warm" in k]
            for e in ("sharded", "serial")}
    print(f"  sharded main path: equal to the serial engine bit for bit: "
          f"{same}; outputs DTensors with Shard(0): "
          f"{all(r['dtensors'] for k, r in runs.items() if 'sharded' in k)};"
          f" the engine's state rows {runs['sharded']['state_rows']}; warm "
          "host enqueue a step (median, ms): sharded "
          + " / ".join(f"{enq[k]:.5f}" for k in warm["sharded"])
          + ", serial " + " / ".join(f"{enq[k]:.5f}" for k in warm["serial"]))
    require(same and runs["sharded"]["y"].shape == (STREAMS, canonical),
            "the sharded main path differs from the serial engine")
    require(all(r["launches"] == (190, 0, 0) for r in runs.values()),
            f"launches {[r['launches'] for r in runs.values()]} (190 K1 "
            "expected each)")
    require(all(r["dtensors"] for k, r in runs.items() if "sharded" in k)
            and runs["sharded"]["state_rows"] == STREAMS,
            "sharded outputs are not DTensors sharded on rows")
    del runs["sharded"]["y"], runs["serial"]["y"]
    return {"x": x, "launches": runs["sharded"]["launches"][0],
            "rate": max(STREAMS * n / runs[k]["wall"] / 1e6
                        for k in warm["sharded"]),
            "k1": k1_at_call("sharded main path step", k1_call)}


def sharded_step_exact(card: str, mesh, x) -> dict:
    """``sharded_stream_step``'s exact branch on 1024 streams: one K1
    launch a step, the stream after the ramp within 2e-5 of ``oneshot``,
    each step's peak (the MAX all-reduce) equal to max|y|."""
    import torch
    from go_audio_resampler_tpu_torch import (EngineCore, Quality, oneshot,
                                              parallel, plan_engine)

    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    init, step, blk = parallel.sharded_stream_step(plan, mesh, STREAMS,
                                                   BLOCK)
    require(blk == BLOCK, f"the step's block {blk}")
    xs = x[:, :SHARD_STEPS * blk]
    with k1_calls() as calls:               # the first collective's set-up
        step(init(), xs[:, :blk])
    state = init()
    ys, peaks, ns = [], [], []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SHARD_STEPS):
        state, y, n_out, peak = step(state, xs[:, i * blk:(i + 1) * blk])
        ys.append(y)
        peaks.append(peak)
        ns.append(n_out)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    sharded = all(is_row_sharded(y) for y in ys)
    peaks_ok = all(float(p) == float(local(y).abs().max())
                   for p, y in zip(peaks, ys))
    got = torch.cat([local(y)[:, :k] for y, k in zip(ys, ns)], dim=1)
    drop = EngineCore(plan, block=BLOCK, device="cpu")._drop
    ref = oneshot(plan, xs)
    m = min(ref.shape[1], got.shape[1] - drop)
    err = (got[:, drop:drop + m] - ref[:, :m]).abs().max().item()
    print(f"  sharded_stream_step (exact, K1): {SHARD_STEPS} steps of "
          f"[{STREAMS}, {blk}] in {wall:.4f} s "
          f"({enqueue / SHARD_STEPS * 1e3:.4f} ms of host enqueue a step), "
          f"launches (K1, K2, K3) "
          f"{launches}; after the ramp's {drop} outputs, {m} outputs within "
          f"{err:.3g} of oneshot; peaks == max|y|: {peaks_ok}; outputs "
          f"DTensors: {sharded} on {card}")
    require(launches == (SHARD_STEPS, 0, 0), f"step launches {launches}")
    require(m > 10 * blk and err <= ENGINE_TOL, f"step vs oneshot: {err}")
    require(peaks_ok and sharded, "step peaks or outputs")
    return {**k1_at_call("sharded step (exact)", calls[0]),
            "launches": launches[0]}


def sharded_walk(gen, card: str, mesh) -> dict:
    """``sharded_stream_step``'s poly-walk branch, 44.1k -> 48.001k HIGH on
    256 streams: one K1 launch (the prestage) a step, within 2e-5 of the
    serial engine's walk after its transient."""
    import torch
    from go_audio_resampler_tpu_torch import (EngineCore, Quality, parallel,
                                              plan_engine)

    plan = plan_engine(RATE_IN, WALK_OUT, Quality.HIGH)
    init, step, blk = parallel.sharded_stream_step(
        plan, mesh, SHARD_WALK_STREAMS, WALK_BLOCK)
    x = 0.5 * torch.randn((SHARD_WALK_STREAMS, SHARD_STEPS * blk),
                          generator=gen, device="cuda")
    state, outs = init(), []
    reset_launches()
    t0 = time.perf_counter()
    with k1_calls() as calls:
        for i in range(SHARD_STEPS):
            state, y, n_out, peak = step(state, x[:, i * blk:(i + 1) * blk])
            outs.append(local(y)[:, :n_out])
    got = torch.cat(outs, dim=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ref = EngineCore(plan, batch=SHARD_WALK_STREAMS, block=blk).process(
        x.cpu().numpy())
    got = got[:, plan.lengths.drop_prefix():].cpu().numpy()
    m = min(got.shape[1], ref.shape[1])
    err = float(np.abs(got[:, :m] - ref[:, :m]).max())
    print(f"  sharded_stream_step (walk): {SHARD_STEPS} steps of "
          f"[{SHARD_WALK_STREAMS}, {blk}] in {wall:.4f} s, launches (K1, "
          f"K2, K3) {launches}; {m} outputs within {err:.3g} of the serial "
          f"walk on {card}")
    require(launches == (SHARD_STEPS, 0, 0), f"walk step launches {launches}")
    require(m > 10 * blk and err <= ENGINE_TOL, f"walk step: {err}")
    return {**k1_at_call("sharded walk step prestage", calls[0]),
            "launches": launches[0]}


def sharded_oneshots(gen, card: str, mesh) -> dict:
    """``sharded_oneshot`` on 64 x 2 s, rational (K1) and general (K3):
    equal to ``oneshot`` bit for bit, a ``DTensor`` sharded on rows.
    Returns the rational call's K1 record and the general call's K3
    record."""
    import torch
    from go_audio_resampler_tpu_torch import (Quality, oneshot, parallel,
                                              plan_engine)

    out = {}
    for name, rate_out, want in (("rational", RATE_OUT, (1, 0, 0)),
                                 ("general", WALK_OUT, (0, 0, 1))):
        plan = plan_engine(RATE_IN, rate_out, Quality.HIGH)
        x = 0.5 * torch.randn((ONESHOT_STREAMS, ONESHOT_SECONDS * RATE_IN),
                              generator=gen, device="cuda")
        reset_launches()
        with k1_calls() as calls, k3_calls() as calls3:
            y, wall, _ = timed(lambda: parallel.sharded_oneshot(plan, x,
                                                                mesh))
        launches = launch_counts()
        ref = oneshot(plan, x)
        same = torch.equal(local(y), ref)
        print(f"  sharded_oneshot ({name}): {tuple(y.shape)} in {wall:.4f} s "
              f"(host design included), launches (K1, K2, K3) {launches}; "
              f"equal to oneshot bit for bit: {same}; DTensor sharded on "
              f"rows: {is_row_sharded(y)} on {card}")
        require(same and is_row_sharded(y) and launches == want,
                f"sharded_oneshot {name}: {launches}, equal {same}")
        if calls:
            out["k1"] = {**k1_at_call("sharded one-shot 44.1k->48k",
                                      calls[0]), "launches": launches[0]}
        if calls3:
            out["k3"] = {**k3_at_call("sharded one-shot 44.1k->48.001k",
                                      calls3[0]), "launches": launches[2]}
    return out


def sharded_stats(card: str, mesh, x) -> None:
    """``global_stream_stats`` against torch on the whole batch."""
    import torch
    from go_audio_resampler_tpu_torch import parallel
    rms, peak = parallel.global_stream_stats(x, mesh)
    want_rms = torch.sqrt((x.double() ** 2).mean()).item()
    want_peak = x.abs().max().item()
    err = abs(rms.item() - want_rms) / want_rms
    print(f"  global_stream_stats: rms {rms.item():.7f} (torch in float64 "
          f"{want_rms:.7f}, relative {err:.3g}), peak {peak.item():.7f} "
          f"(torch {want_peak:.7f}) over {tuple(x.shape)} on {card}")
    require(err <= 1e-5 and peak.item() == want_peak, "global_stream_stats")


def sharded_vr(gen, card: str, mesh) -> dict:
    """``ShardedVariableRateResampler`` beside the serial resampler, 'vr'
    and 'vr-hq', 256 x 10.03 s through ``process_device`` with the
    mid-stream slew: equal bit for bit, K1 launches as derived.  Returns
    K1's record at the sharded 'vr-hq' prestage's shape."""
    import torch
    from go_audio_resampler_tpu_torch import VariableRateResampler, parallel

    n = VR_BLOCKS * VR_BLOCK
    x = 0.5 * torch.randn((VR_STREAMS, n), generator=gen, device="cuda")
    out = {}
    for quality in ("vr", "vr-hq"):
        ys, counts = {}, {}
        for name in ("serial", "sharded"):
            kw = dict(block=VR_BLOCK, quality=quality)
            vr = (parallel.ShardedVariableRateResampler(
                VR_MAX, VR_RATIO, mesh=mesh, batch_per_device=VR_STREAMS,
                **kw) if name == "sharded" else
                VariableRateResampler(VR_MAX, VR_RATIO, batch=VR_STREAMS,
                                      **kw))
            reset_launches()
            parts, sharded = [], True
            with k1_calls() as calls:
                for lo, hi in ((0, VR_MID * VR_BLOCK),
                               (VR_MID * VR_BLOCK, n)):
                    if lo:
                        vr.set_io_ratio(VR_SLEW_TO, slew_len=VR_SLEW_LEN)
                    for a in range(lo, hi, VR_CHUNK_BLOCKS * VR_BLOCK):
                        b = min(hi, a + VR_CHUNK_BLOCKS * VR_BLOCK)
                        y = vr.process_device(x[:, a:b])
                        sharded &= name == "serial" or is_row_sharded(y)
                        parts.append(local(y))
                parts.append(local(vr.flush_device()))
            ys[name] = torch.cat(parts, dim=1)
            counts[name] = launch_counts()
            require(sharded, f"sharded VR {quality}: outputs not DTensors")
        want = vr_launches(vr, n)
        same = torch.equal(ys["sharded"], ys["serial"])
        print(f"  sharded VR {quality}: {tuple(ys['sharded'].shape)}, equal "
              f"to the serial resampler bit for bit: {same}; launches (K1, "
              f"K2, K3) {counts} (derived K1 {want}) on {card}")
        require(same and all(c == (want, 0, 0) for c in counts.values()),
                f"sharded VR {quality}: equal {same}, launches {counts}")
        if quality == "vr-hq":
            out = {**k1_at_call("sharded VR 'vr-hq' prestage", calls[0]),
                   "launches": counts["sharded"][0]}
    return out


def cli_input(seed: int, path: pathlib.Path) -> pathlib.Path:
    """The CLI's input: a 5-minute stereo 24-bit 44.1 kHz file, a 1 kHz
    tone and noise from ``seed``, written to ``path``."""
    from go_audio_resampler_tpu_torch.utils.wav import WavWriter
    n = CLI_SECONDS * RATE_IN
    t = np.arange(n) / RATE_IN
    noise = np.random.default_rng(seed).uniform(-1.0, 1.0, n)
    sig = np.stack([0.5 * np.sin(2 * np.pi * 1000.0 * t), 0.25 * noise],
                   axis=1).astype(np.float32)
    with WavWriter(path, RATE_IN, 2, 24) as w:
        w.write(sig)
    return path


def cli_single(seed: int, card: str, tmp: pathlib.Path) -> dict:
    """``resample_wav`` on a 5-minute stereo 24-bit file, 44.1k -> 48k
    HIGH on the default device: rc 0, the canonical length, bit for bit
    the port's ``EngineCore`` on the decoded input written and read the
    same way, channel 0's THD; K1 at the CLI's step shape."""
    import io
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.cli import resample_wav
    from go_audio_resampler_tpu_torch.utils import metrics
    from go_audio_resampler_tpu_torch.utils.wav import WavReader, WavWriter

    n = CLI_SECONDS * RATE_IN
    src, dst, ref = cli_input(seed, tmp / "in.wav"), tmp / "out.wav", \
        tmp / "ref.wav"
    reset_launches()
    printed = io.StringIO()
    with k1_calls() as calls, contextlib.redirect_stdout(printed):
        t0 = time.perf_counter()
        rc = resample_wav.run([str(src), str(dst)])
        wall = time.perf_counter() - t0
    launches = launch_counts()
    print("  CLI: " + printed.getvalue().strip())
    require(rc == 0, f"resample_wav exited {rc}")
    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    with WavReader(src) as r:
        decoded = r.read(n)
    with WavReader(dst) as r:
        fmt = (r.sample_rate, r.channels, r.bits, r.num_frames)
        got = r.read(r.num_frames)
    eng = EngineCore(plan, batch=2, block=8192)
    reset_launches()
    with WavWriter(ref, RATE_OUT, 2, 24) as w:
        for y in eng.stream(np.ascontiguousarray(decoded[a:a + 65536].T)
                            for a in range(0, n, 65536)):
            w.write(y.T)
    ref_launches = launch_counts()
    with WavReader(ref) as r:
        want = r.read(r.num_frames)
    thd = metrics.thd(got[:, 0].astype(np.float64), RATE_OUT, 1000.0, 16384)
    same = np.array_equal(got, want)
    print(f"  CLI single file: {fmt} (rate, channels, bits, frames; "
          f"canonical {plan.lengths.canonical(n)}); {CLI_SECONDS} s of audio "
          f"in {wall:.3f} s = {CLI_SECONDS / wall:.1f}x realtime (WAV "
          f"decode and encode included); launches (K1, K2, K3) {launches} "
          f"(EngineCore.stream on the decoded input: {ref_launches}); equal "
          f"to it bit for bit: {same}; channel 0 THD {thd:.2f} dB (floor "
          f"{CLI_THD_DB}) on {card}")
    require(fmt == (RATE_OUT, 2, 24, plan.lengths.canonical(n)),
            f"CLI output {fmt}")
    require(same and launches == ref_launches and launches[0] > 0,
            f"CLI differs from EngineCore: equal {same}, launches "
            f"{launches} against {ref_launches}")
    require(thd <= CLI_THD_DB, f"CLI THD {thd} dB")
    return {**k1_at_call("CLI 44.1k->48k, 2 streams", calls[0]),
            "launches": launches[0]}


def cli_batch(seed: int, card: str, tmp: pathlib.Path) -> dict:
    """``resample_wav -outdir`` on 32 stereo files of 5-60 s: each output
    (32-bit float) equal to ``oneshot`` of its own file bit for bit; K1
    at the largest sub-batch's shape."""
    import io
    from go_audio_resampler_tpu_torch import Quality, oneshot, plan_engine
    from go_audio_resampler_tpu_torch.cli import resample_wav
    from go_audio_resampler_tpu_torch.utils.wav import WavReader, WavWriter

    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(5 * RATE_IN, 60 * RATE_IN + 1, CLI_FILES)
    (tmp / "in").mkdir()
    paths = []
    for i, n in enumerate(lengths):
        paths.append(tmp / "in" / f"f{i:02d}.wav")
        t = np.arange(n) / RATE_IN
        with WavWriter(paths[-1], RATE_IN, 2, 16) as w:
            w.write(np.stack([0.5 * np.sin(2 * np.pi * 440.0 * (i + 1) * t),
                              0.25 * rng.uniform(-1, 1, n)],
                             axis=1).astype(np.float32))
    reset_launches()
    printed = io.StringIO()
    with k1_calls() as calls, contextlib.redirect_stdout(printed):
        t0 = time.perf_counter()
        rc = resample_wav.run([str(p) for p in paths] + [
            "-outdir", str(tmp / "out"), "-bits", "32f"])
        wall = time.perf_counter() - t0
    launches = launch_counts()
    print("  CLI: " + printed.getvalue().strip())
    require(rc == 0, f"resample_wav -outdir exited {rc}")
    plan = plan_engine(RATE_IN, RATE_OUT, Quality.HIGH)
    equal = 0
    for p in paths:
        with WavReader(p) as r:
            x = r.read(r.num_frames)
        with WavReader(tmp / "out" / p.name) as r:
            got = r.read(r.num_frames)
        want = oneshot(plan, np.ascontiguousarray(x.T)).cpu().numpy().T
        equal += int(got.shape == want.shape and np.array_equal(got, want))
    print(f"  CLI batch: {CLI_FILES} stereo files of {lengths.min()} to "
          f"{lengths.max()} frames ({lengths.sum() / RATE_IN:.1f} s in "
          f"all) in {wall:.3f} s, {calls.total} sub-batch(es), launches (K1, "
          f"K2, K3) {launches}; outputs equal to oneshot of their own file "
          f"bit for bit: {equal} of {CLI_FILES} on {card}")
    require(equal == CLI_FILES and launches == (calls.total, 0, 0)
            and calls, f"CLI batch: {equal} equal, launches {launches}")
    big = max(calls, key=lambda c: c[0][0].numel())
    return {**k1_at_call("CLI batch sub-batch", big),
            "launches": launches[0]}


def cli_phase(seed: int, card: str) -> dict:
    """The CLI on the card: single file and batch mode, the other tools,
    the native WAV library."""
    import io
    import tempfile
    from go_audio_resampler_tpu_torch.cli import analyze_filter, resample_info
    from go_audio_resampler_tpu_torch.utils import wav

    lib = wav._load_native()
    print(f"  native WAV library: {lib}")
    require(lib is not None, "the native WAV library did not build or load")
    with tempfile.TemporaryDirectory() as tmp:
        records = {"cli_44k_48k": cli_single(seed, card, pathlib.Path(tmp))}
    with tempfile.TemporaryDirectory() as tmp:
        records["cli_batch"] = cli_batch(seed, card, pathlib.Path(tmp))
    for tool, argv in ((resample_info, []),
                       (analyze_filter, ["-phases", "8", "-taps", "16"])):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = tool.run(argv)
        lines = printed.getvalue().strip().splitlines()
        print(f"  {tool.__name__.rsplit('.', 1)[-1]}: rc {rc}; "
              + "; ".join(line.strip() for line in lines[:8]))
        require(rc == 0, f"{tool.__name__} exited {rc}")
    return records


def quality_phase(card: str) -> tuple:
    """The quality tool's full check set on the card; every check passes.
    Returns its (K1, K2, K3) launches."""
    from go_audio_resampler_tpu_torch.tools import quality_cuda
    reset_launches()
    t0 = time.perf_counter()
    results = quality_cuda.run_checks("cuda")
    launches = launch_counts()
    print("  quality: " + json.dumps({
        "card": card, "seconds": round(time.perf_counter() - t0, 1),
        "launches": launches, "failures": results["failures"],
        "checks": {k: v["value"] for k, v in results["checks"].items()}}))
    require(not results["failures"] and len(results["checks"]) == len(
        quality_cuda.LIMITS), f"quality checks failed: {results['failures']}")
    require(launches[0] > 0 and launches[2] > 0, f"quality launches "
            f"{launches}")
    return launches


def roofline_phase(card: str, rates: dict) -> None:
    """``roofline.analyze`` of the main path's measured Msamples/s (the
    serial and the sharded engine) at 'highest' on this card's peaks."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.utils import roofline

    peaks = roofline.device_peaks()
    eng = EngineCore(plan_engine(RATE_IN, RATE_OUT, Quality.HIGH),
                     block=BLOCK, device="cpu")
    r_t, ipx, wx, p2 = eng._band[:4]
    model = roofline.banded_model(p2, wx, ipx,
                                  nnz=int(torch.count_nonzero(r_t)))
    print(f"  roofline: {peaks}; model {model}")
    for label, rate in rates.items():
        a = roofline.analyze(rate, model, "highest", peaks)
        print(f"  roofline {label} ({rate:.1f} Msamples/s in): {a}")
        require(all(0 <= a[k] <= 100 for k in ("mfu_pct", "mfu_slot_pct",
                                               "hbm_pct")),
                f"roofline {label}: a share over 100%: {a}")


def phase14(gen, card: str, seed: int, main_rate: float, k1: dict,
            k3: dict) -> dict:
    """Phase 14: stream sharding at world size 1 on ``nccl``, the CLI,
    the quality tool and the roofline.  Adds K1's and K3's records of
    their shapes; returns the launches by path."""
    import torch
    import torch.distributed as dist
    from go_audio_resampler_tpu_torch import parallel

    t0 = time.perf_counter()
    mesh = parallel.make_mesh(1)
    print(f"  mesh: {mesh}, backend {dist.get_backend()}")
    try:
        main = sharded_main(gen, card, mesh)
        step_k1 = sharded_step_exact(card, mesh, main["x"])
        sharded_stats(card, mesh, main["x"])
        del main["x"]
        torch.cuda.empty_cache()
        walk_k1 = sharded_walk(gen, card, mesh)
        one = sharded_oneshots(gen, card, mesh)
        vr = sharded_vr(gen, card, mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    shapes = k1["shapes"]
    shapes["sharded_main"] = {**main["k1"], "launches": main["launches"]}
    shapes["sharded_step"] = step_k1
    shapes["sharded_walk_prestage"] = walk_k1
    shapes["sharded_oneshot_rational"] = one["k1"]
    shapes["sharded_vr_prestage"] = vr
    k3["shapes"]["sharded_oneshot_general"] = one["k3"]
    print("CLI:")
    shapes.update(cli_phase(seed, card))
    print("quality tool:")
    quality = quality_phase(card)
    print("roofline:")
    roofline_phase(card, {"main path": main_rate,
                          "sharded main path": main["rate"]})
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s")
    return {"sharded main path": main["launches"],
            "sharded step": step_k1["launches"],
            "sharded walk step": walk_k1["launches"],
            "VR 'vr-hq'": vr["launches"],
            "CLI": shapes["cli_44k_48k"]["launches"],
            "CLI batch": shapes["cli_batch"]["launches"],
            "quality tool (K1, K2, K3)": quality}


# -- the lowering selection: dispatch='tune' and set_conv_impl (phase 15) -----

#: The tuned engines: (label, rate in, rate out, streams, block asked for).
#: The main path; the decimation path (block 2048 rounds to 3072); the
#: CLI's engine (cli/resample_wav.py: 2 channels, block 8192).
TUNE_SHAPES = (("main", RATE_IN, RATE_OUT, STREAMS, BLOCK),
               ("decimation", DECIM_IN, DECIM_OUT, DECIM_STREAMS, 2048),
               ("CLI", RATE_IN, RATE_OUT, 2, 8192))
#: Blocks each tuned engine and its pinned twin stream for the bit gate.
TUNE_BLOCKS = 20
#: A lowering this many times faster than the other must be the pin.
TUNE_GATE_RATIO = 2.0


@contextlib.contextmanager
def tune_cache(path: pathlib.Path):
    """``GAR_TUNE_CACHE_FILE`` set to ``path`` inside the block."""
    import os
    saved = os.environ.get("GAR_TUNE_CACHE_FILE")
    os.environ["GAR_TUNE_CACHE_FILE"] = str(path)
    try:
        yield path
    finally:
        if saved is None:
            del os.environ["GAR_TUNE_CACHE_FILE"]
        else:
            os.environ["GAR_TUNE_CACHE_FILE"] = saved


def built(make):
    """(``make()``, the seconds it took)."""
    t0 = time.perf_counter()
    obj = make()
    return obj, time.perf_counter() - t0


def tune_line(label: str, eng, wall: float, card: str) -> None:
    rec = eng.tune_record
    marg = rec.get("marginal_ms") or {}
    print(f"  tune {label} ({eng.batch} x {eng.block}): pin "
          f"{eng.dispatch!r} ({rec['source']}); contrast_s "
          f"{rec.get('contrast_s')}, jitter_s {rec.get('jitter_s')}; "
          "marginal ms a step: " + ", ".join(
              f"{m} {v:.5f}" for m, v in marg.items())
          + f"; tune {rec.get('seconds', 0.0):.4f} s, engine built in "
          f"{wall:.4f} s; {rec['graphs']} graphs captured; on {card}")


def lowering_ms(eng, x) -> dict:
    """Each lowering's device ms of one step of ``eng`` on ``x`` from its
    zero state (``graph_ms``)."""
    out, saved = {}, eng.dispatch
    for mode in ("pallas", "xla"):
        eng.dispatch = mode
        core = eng.core_fn()
        eng.dispatch = saved
        state = eng._init_state()
        out[mode] = graph_ms(lambda: core(state, x), reps=10, iters=10)
    return out


def pin_gate(label: str, eng, x, card: str) -> dict:
    """Gate: where one lowering is TUNE_GATE_RATIO or more faster than
    the other (``graph_ms`` in this run), the pin is that one."""
    ms = lowering_ms(eng, x)
    fast, slow = sorted(ms, key=ms.get)
    ratio = ms[slow] / ms[fast]
    decided = ratio >= TUNE_GATE_RATIO
    print(f"  tune {label}: graph_ms a step: pallas {ms['pallas']:.5f}, xla "
          f"{ms['xla']:.5f}; {fast!r} {ratio:.2f}x faster; "
          + (f"the pin must be {fast!r}: {eng.dispatch!r}" if decided else
             f"under {TUNE_GATE_RATIO}x, any pin passes: {eng.dispatch!r}")
          + f" on {card}")
    require(not decided or eng.dispatch == fast,
            f"tune {label}: pinned {eng.dispatch!r}, but {fast!r} is "
            f"{ratio:.2f}x faster")
    return ms


def device_stream(eng, x) -> tuple:
    """``eng.process_device`` over ``x`` a block at a time, then
    ``flush_device``: (output, K1 launches)."""
    import torch
    reset_launches()
    outs = [eng.process_device(x[:, a:a + eng.block])
            for a in range(0, x.shape[1], eng.block)]
    outs.append(eng.flush_device())
    torch.cuda.synchronize()
    return torch.cat(outs, dim=1), launch_counts()[0]


def tuned_engines(gen, card: str, cache: pathlib.Path) -> dict:
    """The tune at TUNE_SHAPES, each gated against graph_ms and its
    pinned twin's stream; the cache hit; the noise case."""
    import torch
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.engine import streaming

    engines = {}
    for label, rin, rout, streams, block in TUNE_SHAPES:
        plan = plan_engine(rin, rout, Quality.HIGH)
        eng, wall = built(lambda: EngineCore(plan, batch=streams,
                                             block=block, dispatch="tune"))
        tune_line(label, eng, wall, card)
        require(eng.dispatch in ("pallas", "xla", "auto")
                and eng.tune_record["source"] == "measured"
                and eng.tune_record["graphs"] == 4,
                f"tune {label}: {eng.dispatch!r}, {eng.tune_record}")
        x = 0.5 * torch.randn((streams, TUNE_BLOCKS * eng.block),
                              generator=gen, device="cuda")
        pin_gate(label, eng, x[:, :eng.block], card)
        twin = EngineCore(plan, batch=streams, block=block,
                          dispatch=eng.dispatch)
        got, launches = device_stream(eng, x)
        want, twin_launches = device_stream(twin, x)
        same = torch.equal(got, want)
        print(f"  tune {label}: process_device stream {tuple(got.shape)} "
              f"equal bit for bit to dispatch={eng.dispatch!r}: {same}; K1 "
              f"launches {launches} (the pinned engine's {twin_launches})")
        require(same and launches == twin_launches
                and (launches > 0) == (eng.dispatch != "xla"),
                f"tune {label}: equal {same}, launches {launches} against "
                f"{twin_launches}")
        engines[label] = (plan, eng, launches)
    pinned = [lab for lab, (_, e, _) in engines.items() if e.dispatch != "auto"]
    require(pinned, "no tuned shape pinned a lowering")
    plan, first, _ = engines[pinned[0]]
    second, wall = built(lambda: EngineCore(plan, batch=first.batch,
                                            block=first.block,
                                            dispatch="tune"))
    print(f"  tune cache hit ({pinned[0]}): pin {second.dispatch!r} "
          f"({second.tune_record['source']}), {second.tune_record['graphs']} "
          f"graphs captured, engine built in {wall * 1e3:.3f} ms on {card}")
    require(second.tune_record["source"] == "cache"
            and second.tune_record["graphs"] == 0
            and second.dispatch == first.dispatch,
            f"second engine: {second.tune_record}")
    refused = [e for _, e, _ in engines.values() if e.dispatch == "auto"]
    if not refused:
        noise, wall = built(lambda: EngineCore(
            plan_engine(RATE_IN, RATE_OUT, Quality.HIGH), batch=1, block=512,
            dispatch="tune"))
        tune_line("noise case (1 x 512)", noise, wall, card)
        refused = [noise] if noise.dispatch == "auto" else []
    for eng in refused:
        entry = streaming._tune_cache_get(eng._tune_key())
        print(f"  tune noise case ({eng.batch} x {eng.block}): pin 'auto', "
              f"cache entry for its key: {entry}")
        require(entry is None, f"a refused tune wrote {entry}")
    if not refused:
        print("  tune noise case: the 1 x 512 engine pinned too; nothing "
              "refused, so nothing to check")
    entries = json.loads(cache.read_text())
    print(f"  tune cache {cache.name}: {len(entries)} entries, "
          + "; ".join(f"{v}" for v in entries.values()))
    return engines


def tuned_tmajor(gen, card: str, pin: str) -> dict:
    """``TimeMajorEngine(dispatch='tune')`` at the main shape: the pin of
    its inner EngineCore, and K2 against its plain version at its step."""
    import torch
    from go_audio_resampler_tpu_torch import (Quality, TimeMajorEngine,
                                              plan_engine)
    from go_audio_resampler_tpu_torch.ops import tmajor

    tm, wall = built(lambda: TimeMajorEngine(
        plan_engine(RATE_IN, RATE_OUT, Quality.HIGH), batch=STREAMS,
        block=BLOCK, dispatch="tune"))
    # The main EngineCore's pin is in the cache under the same key, unless
    # it refused (then the inner engine measures anew).
    require(pin == "auto" or tm.dispatch == pin,
            f"TimeMajorEngine pinned {tm.dispatch!r}, EngineCore {pin!r}")
    data = 0.5 * torch.randn((tm._carry_len + tm.block, STREAMS),
                             generator=gen, device="cuda")
    kw = dict(ipx=tm._ipx, wx=tm._wx, p2=tm._p2,
              n_frames=tm.block // tm._ipx, tier="highest")
    reset_launches()
    y = tmajor.fused_resample_tmajor(data, tm._r, op=tm._op, **kw)
    launches = launch_counts()[1]
    ref = tmajor.fused_resample_tmajor_reference(data, tm._r, **kw)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item() / ref.abs().max().item()
    ms = graph_ms(lambda: tmajor.fused_resample_tmajor(data, tm._r,
                                                       op=tm._op, **kw))
    plain_ms = graph_ms(lambda: tmajor.fused_resample_tmajor_reference(
        data, tm._r, **kw), reps=5, iters=5)
    print(f"  tune TimeMajorEngine (main, {STREAMS} x {tm.block}): pin "
          f"{tm.dispatch!r} (its inner EngineCore's, measured on K1), built "
          f"in {wall:.4f} s; K2 at its step {tuple(data.shape)}: kernel "
          f"{ms:.5f} ms, plain {plain_ms:.5f} ms, max |kernel - plain| = "
          f"{err:.3g} of max|y| on {card}")
    require(launches == 1 and err <= KERNEL_TOL,
            f"K2 at the tuned step: launches {launches}, error {err}")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "launches": launches, "pin": tm.dispatch}


def tuned_entry_points(gen, seed: int, card: str,
                       tmp: pathlib.Path) -> None:
    """``Config(dispatch='tune')`` at 256 channels, the CLI's ``-dispatch
    tune`` and ``ShardedEngineCore`` at world size 1, each into a fresh
    cache so that each measures."""
    import torch
    import torch.distributed as dist
    from go_audio_resampler_tpu_torch import Quality, parallel, plan_engine
    from go_audio_resampler_tpu_torch.cli import resample_wav

    with tune_cache(tmp / "api.json"):
        r, wall = built(lambda: api_resampler(RATE_IN, RATE_OUT, 3,
                                              dispatch="tune"))
    pins = [e.dispatch for e in r._exec]
    require(len(set(pins)) == 1, f"API engines pinned {pins}")
    ref = api_resampler(RATE_IN, RATE_OUT, 3, dispatch=pins[0])
    mult = r.device_chunk_multiple
    x = 0.5 * torch.randn((API_CHANNELS, 40 * mult), generator=gen,
                          device="cuda")
    got = torch.cat([r.process_multi_device(x), r.flush_multi_device()], 1)
    want = torch.cat([ref.process_multi_device(x),
                      ref.flush_multi_device()], 1)
    same = torch.equal(got, want)
    rec = r._exec[0].tune_record
    print(f"  tune Resampler ({API_CHANNELS} channels, block "
          f"{r._exec[0].block}): pins {pins} ({rec['source']}, contrast_s "
          f"{rec.get('contrast_s')}, jitter_s {rec.get('jitter_s')}), built "
          f"in {wall:.4f} s; output {tuple(got.shape)} equal bit for bit to "
          f"Config(dispatch={pins[0]!r}): {same} on {card}")
    require(same, "the tuned Resampler differs from its pinned config")

    src = cli_input(seed, tmp / "in.wav")
    with tune_cache(tmp / "cli.json") as cache:
        t0 = time.perf_counter()
        rc = resample_wav.run([str(src), str(tmp / "tune.wav"),
                               "-dispatch", "tune"])
        wall = time.perf_counter() - t0
        entries = (json.loads(cache.read_text()) if cache.exists() else {})
    require(rc == 0 and len(entries) <= 1, f"CLI -dispatch tune: rc {rc}, "
            f"cache {entries}")
    pin = next(iter(entries.values()))["winner"] if entries else "auto"
    rc_pin = resample_wav.run([str(src), str(tmp / "pin.wav"), "-dispatch",
                               pin])
    outs = {k: (tmp / f"{k}.wav").read_bytes() for k in ("tune", "pin")}
    same = outs["tune"] == outs["pin"]
    print(f"  tune CLI ({CLI_SECONDS} s stereo): -dispatch tune rc {rc} in "
          f"{wall:.3f} s, pin {pin!r} (its cache: {entries}); -dispatch "
          f"{pin} rc {rc_pin}; outputs equal bit for bit: {same} "
          f"({len(outs['tune'])} bytes) on {card}")
    require(rc_pin == 0 and same, "CLI -dispatch tune differs from its pin")

    mesh = parallel.make_mesh(1)
    try:
        with tune_cache(tmp / "sharded.json"):
            eng, wall = built(lambda: parallel.ShardedEngineCore(
                plan_engine(RATE_IN, RATE_OUT, Quality.HIGH), mesh,
                batch_per_device=STREAMS, block=BLOCK, dispatch="tune"))
        tune_line("ShardedEngineCore (world size 1, main)", eng, wall, card)
        require(eng.dispatch in ("pallas", "xla", "auto")
                and eng.tune_record["pin"] == eng.dispatch,
                f"sharded tune: {eng.dispatch!r}, {eng.tune_record}")
    finally:
        dist.destroy_process_group()


def conv_impls(gen, card: str) -> dict:
    """``set_conv_impl`` at the walk prestage's shape ([256, 2213] x
    [293, 256]): None and 'banded' launch K1, 'frames' and 'xla' none;
    each within 2e-5 of max|y| of K1's output with cuDNN's TF32 left at
    its default (on) around the calls, so 'xla' passes only with TF32
    off inside it; each lowering's graph_ms; the override None after.
    Returns K1's record at this shape."""
    import torch
    import torch.nn.functional as F
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.ops import convolve

    eng = EngineCore(plan_engine(RATE_IN, WALK_OUT, Quality.HIGH),
                     batch=WALK_STREAMS, block=WALK_BLOCK)
    band, coeffs = eng._pre_band(WALK_BLOCK), eng.pre_coeffs
    xext = 0.5 * torch.randn((WALK_STREAMS, coeffs.shape[1] - 1 + WALK_BLOCK),
                             generator=gen, device="cuda")
    require((tuple(xext.shape), tuple(band.r_t.shape))
            == ((256, 2213), (293, 256)),
            f"prestage shape {tuple(xext.shape)} x {tuple(band.r_t.shape)}")

    def conv():
        return convolve.conv1d_poly_interleaved(xext, coeffs, "highest",
                                                band=band)

    real_conv1d, tf32_inside = F.conv1d, []

    def conv1d_spy(*args, **kw):
        tf32_inside.append(torch.backends.cudnn.allow_tf32)
        return real_conv1d(*args, **kw)

    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True         # cuDNN's default
    outs, k1_launches = {}, 0
    try:
        for impl in (None, "banded", "frames", "xla"):
            convolve.set_conv_impl(impl)
            reset_launches()
            F.conv1d = conv1d_spy
            try:
                y = conv()
            finally:
                F.conv1d = real_conv1d
            torch.cuda.synchronize()
            launched = launch_counts()[0]
            k1_launches += launched
            ms = graph_ms(conv, reps=10, iters=10)
            outs[impl] = (y, launched, ms)
        convolve.set_conv_impl(None)
        tf32_kept = torch.backends.cudnn.allow_tf32
        tf32_conv = F.conv1d(xext[:, None, :], coeffs[:, None, :]).transpose(
            1, 2).reshape(xext.shape[0], -1)
    finally:
        convolve.set_conv_impl(None)
        torch.backends.cudnn.allow_tf32 = saved_tf32
    ref = outs[None][0]
    peak = ref.abs().max().item()
    tf32_err = (tf32_conv - ref).abs().max().item() / peak
    for impl, (y, launched, ms) in outs.items():
        err = (y - ref).abs().max().item() / peak
        print(f"  set_conv_impl({impl!r}) at {tuple(xext.shape)} x "
              f"{tuple(band.r_t.shape)}: {launched} K1 launches, max |y - "
              f"K1's| = {err:.3g} of max|y|, graph_ms {ms:.5f} on {card}")
        require(launched == (1 if impl in (None, "banded") else 0)
                and err <= KERNEL_TOL, f"set_conv_impl({impl!r}): "
                f"{launched} launches, error {err}")
    print(f"  F.conv1d with cuDNN's TF32 on (its default) at this shape: "
          f"{tf32_err:.3g} of max|y|; cuDNN's allow_tf32 inside the 'xla' "
          f"lowering's F.conv1d calls: {tf32_inside}, after them: "
          f"{tf32_kept}; the override after the phase: "
          f"{convolve._IMPL_OVERRIDE}")
    require(tf32_inside == [False] and tf32_kept
            and convolve._IMPL_OVERRIDE is None,
            f"set_conv_impl: TF32 inside {tf32_inside}, after {tf32_kept}, "
            f"override {convolve._IMPL_OVERRIDE}")
    rec = prestage_k1("conv impl prestage", band, coeffs, xext)
    return {**rec, "launches": k1_launches,
            "impl_ms": {str(k): v[2] for k, v in outs.items()}}


def phase15(gen, seed: int, card: str, k1: dict, k2: dict) -> dict:
    """Phase 15: ``dispatch='tune'`` at three shapes and through every
    entry point, and ``set_conv_impl``; the tune cache in a fresh
    temporary directory.  Adds K1's and K2's records; returns the
    launches by path."""
    import tempfile
    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        with tune_cache(tmp / "tune.json") as cache:
            engines = tuned_engines(gen, card, cache)
            torch.cuda.empty_cache()
            tm = tuned_tmajor(gen, card, engines["main"][1].dispatch)
        torch.cuda.empty_cache()
        tuned_entry_points(gen, seed, card, tmp)
    torch.cuda.empty_cache()
    conv = conv_impls(gen, card)
    k1["shapes"]["conv_impl_prestage"] = conv
    k2["shapes"]["tune_tmajor_main"] = tm
    print(f"  phase 15 took {time.perf_counter() - t0:.1f} s")
    return {**{f"tuned {lab} stream": n for lab, (_, _, n) in
               engines.items()}, "set_conv_impl": conv["launches"]}


def example_errors(name: str, card_out: dict, cpu_out: dict) -> float:
    """An example's returned values on the card against its CPU run:
    each array within KERNEL_TOL of its peak (returns the largest share),
    each length and count equal."""
    import torch

    require(card_out.keys() == cpu_out.keys(),
            f"example {name}: keys {sorted(card_out)} on the card, "
            f"{sorted(cpu_out)} on the CPU")
    worst = 0.0
    for key, want in cpu_out.items():
        got = card_out[key]
        if isinstance(want, np.ndarray):
            require(got.shape == want.shape, f"example {name} {key}: shape "
                    f"{got.shape} on the card, {want.shape} on the CPU")
            _, err = rel_err(torch.as_tensor(got, dtype=torch.float64),
                             torch.as_tensor(want, dtype=torch.float64))
            require(err <= KERNEL_TOL, f"example {name} {key}: {err:.3g} "
                    "of max|y| from the CPU run")
            worst = max(worst, err)
        elif isinstance(want, int):
            require(got == want, f"example {name} {key}: {got} on the "
                    f"card, {want} on the CPU")
    return worst


def phase16(card: str) -> dict:
    """Phase 16: the six examples on the card, each held against its CPU
    run; returns the launches (K1, K2, K3) by example."""
    import importlib
    import io
    import torch
    from go_audio_resampler_tpu_torch.examples import NAMES

    t_all = time.perf_counter()
    launches = {}
    for name in NAMES:
        mod = importlib.import_module(
            f"go_audio_resampler_tpu_torch.examples.{name}")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = mod.main(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            ref = mod.main(device="cpu")
        err = example_errors(name, out, ref)
        floats = ", ".join(f"{key} {out[key]:.6g} (CPU {ref[key]:.6g})"
                           for key in out if isinstance(out[key], float))
        print(f"  example {name}: {wall:.3f} s on the card; launches K1 "
              f"{counts[0]}, K2 {counts[1]}, K3 {counts[2]}; arrays within "
              f"{err:.3g} of max|y| of the CPU run"
              + (f"; {floats}" if floats else "") + f"; {card}")
        want = EXAMPLE_KERNELS[name]
        require([c > 0 for c in counts] == [k in want for k in
                                            ("K1", "K2", "K3")],
                f"example {name}: launches {counts}, expected {want}")
        if name == "hq_and_time_major":
            require(out["thd_hq_db"] <= EXAMPLE_THD_HQ_DB,
                    f"example {name}: hq_interp THD {out['thd_hq_db']} dB")
        launches[name] = counts
    print(f"  phase 16 took {time.perf_counter() - t_all:.1f} s")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile warm steps of the main, "
                         "time-major, decimation and general-walk paths "
                         "(where the time goes)")
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
        for line in ptxas_summary(log):
            print(f"  ptxas {name}: {line}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    print("kernels:")
    k1 = kernel_phase(gen)
    k2 = k2_phase(gen)
    k3 = k3_phase(gen)
    print("precision tiers, kernels and one-shot:")
    tiered, want = {}, None
    x_oneshot = 0.5 * torch.randn((ONESHOT_STREAMS, ONESHOT_SECONDS
                                   * RATE_IN), generator=gen, device="cuda")
    for tier in TIERS:
        tiered[tier] = tier_kernels(gen, tier)
        tiered[tier][2]["launches"], want = tier_oneshot(x_oneshot, card,
                                                         tier, want)
    del x_oneshot
    print("main path:")
    main_run = main_path(gen, card)
    k1["launches"] = main_run["launches"]
    main_rate = main_run["rate"]
    print("time-major path:")
    k2["launches"] = tmajor_path(main_run, card)
    print("precision tiers, engines and the dispatch gate:")
    for tier in TIERS:
        launches = tier_engines(main_run, card, tier)
        for entry, count in zip(tiered[tier], launches):
            entry["launches"] = count
    del main_run
    torch.cuda.empty_cache()
    print("decimation path:")
    decim_k1, decim_k2 = decim_path(gen, card)
    print("one-shot:")
    oneshot_k1, k3_by_shape, general = oneshot_phase(gen, card)
    k3["launches"] = sum(k3_by_shape.values())
    for shape, count in k3_by_shape.items():
        k3["shapes"][shape]["launches"] = count
    print(f"  launches by path: K1 {k1['launches']} (main path), "
          f"{decim_k1} (decimation), {oneshot_k1} (one-shot); K2 "
          f"{k2['launches']} (time-major), {decim_k2} (decimation); K3 "
          f"{k3['launches']} (one-shot)")
    require((k1["launches"], decim_k1, oneshot_k1, k2["launches"], decim_k2,
             k3["launches"]) == (190, 158, 3, 190, 158, 2),
            "launch counts differ from 190/158/3 (K1), 190/158 (K2), 2 (K3)")
    k1["shapes"]["main"]["launches"] = k1["launches"]
    k1["shapes"]["decimation"]["launches"] = decim_k1
    k2["shapes"]["main"]["launches"] = k2["launches"]
    k2["shapes"]["decimation"]["launches"] = decim_k2
    torch.cuda.empty_cache()
    print("general walk:")
    walk = walk_path(gen, card, general, args.profile)
    k1["shapes"]["walk_prestage"] = {**walk["k1"],
                                     "launches": walk["launches"]}
    print("dft_up and cubic:")
    dft_k1 = dft_cubic_phase(gen, card)
    print(f"  launches by path: K1 {walk['launches']} (general walk), "
          f"{dft_k1} (dft_up stream); cubic none")
    torch.cuda.empty_cache()
    print("strict antialias and banded composites:")
    comp = composite_path(gen, card)
    torch.cuda.empty_cache()
    strict = strict_path(gen, card)
    torch.cuda.empty_cache()
    head_free = head_free_path(gen, card)
    torch.cuda.empty_cache()
    strict_walk = strict_walk_path(gen, card)
    k1["shapes"]["composite_96k_44k"] = comp["k1"]
    k1["shapes"]["strict_48k_44k"] = strict["k1"]
    k1["shapes"]["aa_prefilter"] = strict_walk["k1"]
    k2["shapes"]["composite_192k_48k"] = head_free["k2"]
    print(f"  launches by path: K1 {comp['launches']} (composite "
          f"96k->44.1k), {strict['launches']} (strict 48k->44.1k), "
          f"{head_free['k1_launches']} (head-free composite, EngineCore), "
          f"{strict_walk['launches']} (strict walk: prefilter and "
          f"prestage), {strict_walk['oneshot_k1']} (one-shot B and D); K2 "
          f"{head_free['launches']} (head-free composite); K3 "
          f"{strict_walk['oneshot_k3']} (one-shot D)")
    print("public API and FFT routes:")
    api = api_fft_phase(gen, card)
    k1["shapes"]["api_48k_16k"] = api["k1_api_c"]
    print(f"  launches by path: K1 {api['api_a']} (API-A), {api['api_b']} "
          f"(API-B), {api['k1_api_c']['launches']} (API-C), "
          f"{api['api_d'][0]} (API-D), {api['conv_k1']} (resample_stereo), "
          f"{api['fft_walk']} (FFT-2, the prestage), {api['fft_decim_k1']} "
          f"(FFT-3's K1 route); K3 {api['api_d'][2]} (API-D), "
          f"{api['conv_k3']} (resample_mono); the FFT routes launch none")
    torch.cuda.empty_cache()
    print("variable rate, checkpoints, functional and shims:")
    shapes13 = phase13(gen, card, general)
    del general
    k1["shapes"].update(shapes13)
    print("  launches by path: K1 " + ", ".join(
        f"{rec['launches']} ({name})" for name, rec in shapes13.items())
          + "; K2 and K3 none")
    torch.cuda.empty_cache()
    print("sharding, the CLI, the quality tool and the roofline:")
    launches14 = phase14(gen, card, args.seed, main_rate, k1, k3)
    print("  launches by path: K1 " + ", ".join(
        f"{count} ({name})" for name, count in launches14.items()))
    print("dispatch='tune' and set_conv_impl:")
    launches15 = phase15(gen, args.seed, card, k1, k2)
    print("  launches by path: K1 " + ", ".join(
        f"{count} ({name})" for name, count in launches15.items()))
    print("examples:")
    launches16 = phase16(card)
    print("  launches by example: " + ", ".join(
        f"{name} K1 {k1n} K2 {k2n} K3 {k3n}"
        for name, (k1n, k2n, k3n) in launches16.items()))
    print("chunking:")
    chunking_phase(args.seed)
    if args.profile:
        print("profile:")
        profile_phase(gen)

    print(card)
    print(json.dumps({"kernels": [k1, k2, k3] + [
        entry for tier in TIERS for entry in tiered[tier]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
