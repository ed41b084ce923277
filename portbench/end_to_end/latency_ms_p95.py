"""The 95th percentile of every request's time, from its call until its
output is on the host or synchronised on the card."""

import numpy as np


def read(run):
    return float(np.percentile([(r.t_done - r.t_call) * 1e3
                                for r in run.requests], 95))
