"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` is what ``run.py`` calls on the card; the tests call it on the
CPU at a small size.  Its steps:

1. Set-up: the entry named by the cell's traffic mix builds the program's
   object and its input pools from the seed, then runs the mix's warm-up
   requests through the same object (they are the stream's first steps).
   An entry makes each request's input ready (``prepare``) before the
   request's clock starts.
   ``setup_s`` runs from the process's start to the first timed request.
2. The window: requests in a closed loop, each timed on the host clock
   from its call until its output is on the host or synchronised on the
   card (or, for an entry that keeps steps in flight on the card, until
   it returns; the last one ends when the card has finished it), until
   ``seconds`` have passed.  With ``trace`` the last
   ``trace_seconds`` of the window run under ``torch.profiler``, each
   request inside a span of the benchmark's own.
3. The check, once the window has closed, the peak memory has been read
   and the program's object freed: the entry compares what the timed path
   produced (a sample of requests and streams drawn from the seed, and the
   output counts of every request) with the plain reference, and each
   number compared is held to the cell's limit.
4. The metrics: the cell's end-to-end metrics, or with ``trace`` its
   per-layer metrics, each read by a reader of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import time

import torch

from . import costs, generator, manifest, trace
from .reference import design


@dataclasses.dataclass
class Context:
    """What an entry is built from."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device
    tier: str               # the products' precision tier
    filters: object         # the reference's design of the configuration
    #: 'tf32': the check compares the reference computed in TF32 in the
    #: program's place (the control); None compares the program.
    control: str | None = None


@dataclasses.dataclass
class Request:
    """One request of the window, timed on the host clock."""

    i: int
    t_call: float
    t_return: float
    t_done: float
    n_in: int              # input samples of every stream
    ops: int
    nbytes: int
    trace: int             # which trace holds it; 0 for none


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: manifest.Cell
    card: str
    setup_s: float
    requests: list          # the window's requests
    timeline: trace.Timeline | None
    traced: list            # the requests of ``timeline``, in order


@dataclasses.dataclass
class Verdict:
    """What an entry's check found: each number compared, and how many
    requests it found wrong beside the values (counts, lengths)."""

    numbers: dict
    request_errors: dict    # request -> its largest relative error
    wrong_counts: int


def card_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None, tier: str | None = None,
             control: str | None = None, log=print) -> dict:
    """Run ``workload`` once; returns the result line's object with the
    compared numbers under ``checks``.

    ``overrides`` replaces keys of the traffic mix (the tests' small
    sizes); ``tier`` replaces the configuration's precision tier, and
    ``control='tf32'`` puts the reference computed in TF32 in the
    program's place in the check (the controls).  ``log`` takes the lines
    printed before the result.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.cell(workload)
    traffic = {**cell.traffic, **(overrides or {})}
    config = cell.config
    device = torch.device(device)
    tier = tier or config["precision"]
    ctx = Context(config=config, traffic=traffic, seed=seed, device=device,
                  tier=tier, control=control,
                  filters=design.design(config["input_rate"],
                                        config["output_rate"],
                                        config["quality"]))
    saved_tier = os.environ.get("GAR_TPU_MATMUL_PRECISION")
    # The program's process-wide tier, read per call by its one-shot and
    # functional entries; the engines take it as an argument.
    os.environ["GAR_TPU_MATMUL_PRECISION"] = tier
    try:
        return _run(cell, ctx, seconds, trace_on, t_start, log)
    finally:
        if saved_tier is None:
            os.environ.pop("GAR_TPU_MATMUL_PRECISION", None)
        else:
            os.environ["GAR_TPU_MATMUL_PRECISION"] = saved_tier


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _segments(device: torch.device) -> int:
    """How many segments the caching allocator has taken from the driver
    (``cudaMalloc`` calls) since the process began."""
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


def _run(cell, ctx, seconds, trace_on, t_start, log) -> dict:
    from go_audio_resampler_tpu_torch.ops import fused
    device = ctx.device
    card = card_name(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv = manifest.entry(ctx.traffic["entry"]).Driver(ctx)
    warm = {}
    for i in range(drv.warmup_requests):
        drv.prepare(i)
        ret = drv.call(i)
        drv.finish(ret)
        drv.record(i, ret)
        warm[i] = drv.sample(i, ret)
    _sync(device)
    launches0 = fused.launches
    segments0 = _segments(device)
    sample = generator.Reservoir(int(ctx.traffic["sample_requests"]),
                                 ctx.seed)
    tracer = trace.Tracer() if trace_on else None
    trace_s = float(ctx.traffic["trace_seconds"])
    traces, tracing, timeline, good = 0, False, None, 0
    requests = []
    i = drv.warmup_requests
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    deadline = t_first + seconds
    # A traced run profiles the window's last ``trace_s`` seconds, so the
    # requests before them run as in an untraced run.
    trace_start, trace_end = deadline - trace_s, math.inf
    while True:
        now = time.perf_counter()
        if tracing and now >= trace_end:
            _sync(device)
            tl = tracer.stop()
            tracing = False
            if tl.device and tl.spans:
                timeline, good = tl, traces
            now = time.perf_counter()
        if (tracer is not None and not tracing and timeline is None
                and traces < 3 and now >= trace_start):
            # The trace starts after a synchronise, so it holds the work
            # of the requests it spans and no other; one without the
            # card's events is taken again, three times at most.
            _sync(device)
            traces, tracing = traces + 1, True
            tracer.start()
            trace_end = time.perf_counter() + trace_s
        if now >= deadline and requests and not tracing:
            break
        drv.prepare(i)
        with tracer.span() if tracing else contextlib.nullcontext():
            t0 = time.perf_counter()
            ret = drv.call(i)
            t1 = time.perf_counter()
            drv.finish(ret)
            t2 = time.perf_counter()
        n_in, ops, nbytes = drv.record(i, ret)
        if sample.slot(i):
            sample.kept[i] = drv.sample(i, ret)
        requests.append(Request(i, t0, t1, t2, n_in, ops, nbytes,
                                traces if tracing else 0))
        del ret
        i += 1
    _sync(device)
    if not getattr(drv, "synchronised", True):
        # Steps kept in flight: the last one is done, and the window
        # closes, when the card has finished it.
        requests[-1].t_done = time.perf_counter()
    window = requests[-1].t_done - requests[0].t_call
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if device.type == "cuda":
        smi = costs.nvidia_smi("clocks.sm,power.draw,power.limit,"
                               "temperature.gpu")
        log(f"after the window, clocks, power, limit, temperature: {smi}")
    lat = sorted(r.t_done - r.t_call for r in requests)
    log(f"{cell.name}: {len(requests)} requests in {window:.6f} s after "
        f"{len(warm)} warm-up requests; setup {setup_s:.6f} s; latency "
        f"median {lat[len(lat) // 2] * 1e3:.6f} ms over {len(lat)} "
        f"requests; K1 launches {fused.launches - launches0} in the window "
        f"({(fused.launches - launches0) / len(requests):g} a request); "
        f"device segments allocated (cudaMalloc) in the window "
        f"{_segments(device) - segments0}")

    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = drv.verify({**warm, **sample.kept})
    log(f"check: {len(warm) + len(sample.kept)} requests compared in "
        f"{time.perf_counter() - t_check:.3f} s")
    checks, correct = {}, True
    for name, value in verdict.numbers.items():
        limit = cell.limits[name]
        ok = not math.isnan(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    bad_values = sum(1 for e in verdict.request_errors.values()
                     if not e <= cell.limits["max_rel_err"])

    traced = ([r for r in requests if r.trace == good] if timeline else [])
    run = Run(cell=cell, card=card, setup_s=setup_s, requests=requests,
              timeline=timeline, traced=traced)
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = manifest.reader(m["name"], trace_on).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card, "count": cell.chips if device.type == "cuda" else 0,
           "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": min(len(requests), verdict.wrong_counts + bad_values),
              "metrics": metrics, "device": dev}
    if trace_on:
        if timeline is not None:
            lo, hi = timeline.window
            dev["busy_s"] = timeline.busy_ns(lo, hi) / 1e9
            dev["window_s"] = (hi - lo) / 1e9
            result["breakdown"] = {"device_ops": timeline.device_ops(),
                                   "idle_gaps": timeline.idle_gaps()}
        log(f"traces taken: {traces}; the one read: {good or 'none'}, "
            f"{len(traced)} requests, "
            f"{len(timeline.device) if timeline else 0} device events")
    result["checks"] = checks
    return result
