"""Device time a step of every kernel but the resampling product."""

from portbench.readers import PRODUCT_KERNEL, kernel_ns, per_request_mean


def read(run):
    if run.timeline is None:
        return None
    other = kernel_ns(run, lambda name: PRODUCT_KERNEL not in name)
    return per_request_mean(run, lambda lo, hi: other(lo, hi) / 1e6)
