"""The least time the card needs for a request's work over its kernels'
device time (``portbench/costs.py``), in %."""

from portbench.readers import roofline_pct


def read(run):
    return roofline_pct(run)
