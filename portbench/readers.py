"""What the metric readers share: the window's requests on the host clock,
and the trace's device time split by request."""

from __future__ import annotations

import statistics

from portbench import costs

#: The resampling product's kernel (K1, ``ops/csrc/fused_resample.cu``).
PRODUCT_KERNEL = "fused_resample_kernel"


def per_request_mean(run, fn):
    """The mean over the traced requests of ``fn(lo_ns, hi_ns)`` on each
    request's span; None where no trace holds the card's work."""
    tl = run.timeline
    if tl is None or not tl.spans:
        return None
    return statistics.fmean(tl.per_span(fn))


def untraced(run):
    """The window's requests that ran outside any trace: in a traced run,
    those before the trace began."""
    return [r for r in run.requests if r.trace == 0]


def kernel_ns(run, keep=lambda name: True):
    """``fn(lo, hi)``: summed device time of the kernels issued in [lo, hi)
    whose name ``keep`` accepts."""
    return lambda lo, hi: run.timeline.summed_ns(
        lo, hi, lambda name, kind: kind == "kernel" and keep(name))


def idle_share(run):
    """1 - (the union of the card's kernels and copies over the traced
    window) / the window."""
    tl = run.timeline
    if tl is None or not tl.spans:
        return None
    lo, hi = tl.window
    return 1.0 - tl.busy_ns(lo, hi) / (hi - lo)


def roofline_pct(run):
    """The least time the card needs for the traced requests' work
    (``costs``), as a share of the device time of every kernel in the
    trace, in %.  The trace holds the traced requests' work and nothing
    else (it starts and ends with a synchronise), so the sum needs no
    kernel tied to its request: a kernel
    launched where the profiler records no host call for it, and run
    while the host is in a later request, counts all the same."""
    tl = run.timeline
    if tl is None or not tl.spans or len(tl.spans) != len(run.traced):
        return None
    busy = sum(b - a for (a, b, _), kind in zip(tl.device, tl.kinds)
               if kind == "kernel")
    if busy <= 0:
        return None
    least = sum(costs.least_seconds(run.card, r.ops, r.nbytes)
                for r in run.traced)
    return 100.0 * least / (busy / 1e9)
