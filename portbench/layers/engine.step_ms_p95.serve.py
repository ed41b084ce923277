"""The 95th percentile of a step's time on the host clock, from the call
of ``EngineCore.process`` with the frame on the host to its output array
on the host, over the steps before the trace (the profiler's cost is not
in them).  A tail beside ``in_msamples_per_s.host``, with no bound:
it moves from process to process more than a bound may allow."""

import numpy as np

from portbench.readers import untraced


def read(run):
    reqs = untraced(run)
    if not reqs:
        return None
    return float(np.percentile([(r.t_done - r.t_call) * 1e3 for r in reqs],
                               95))
