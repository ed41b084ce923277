"""Host time of a call, from the call of ``functional.resample`` to its
return before the synchronise, over the requests that ran before the
trace (the profiler's cost is not in them)."""

import statistics

from portbench.readers import untraced


def read(run):
    reqs = untraced(run)
    if not reqs:
        return None
    return statistics.fmean((r.t_return - r.t_call) * 1e3 for r in reqs)
