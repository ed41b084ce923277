"""A step's time on the host: the mean step, on the host clock over the
requests that ran before the trace (the profiler's cost is not in them),
less the mean device time of the work that a traced step issued."""

import statistics

from portbench.readers import per_request_mean, untraced


def read(run):
    tl, reqs = run.timeline, untraced(run)
    device_ms = None if tl is None else per_request_mean(
        run, lambda lo, hi: tl.summed_ns(lo, hi, lambda name, kind: True)
        / 1e6)
    if device_ms is None or not reqs:
        return None
    return statistics.fmean((r.t_done - r.t_call) * 1e3
                            for r in reqs) - device_ms
