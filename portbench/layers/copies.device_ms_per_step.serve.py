"""Device time of the host-to-device and device-to-host copies that a
step issued."""

from portbench.readers import per_request_mean


def read(run):
    tl = run.timeline
    return per_request_mean(run, lambda lo, hi: tl.summed_ns(
        lo, hi, lambda name, kind: kind == "copy") / 1e6)
