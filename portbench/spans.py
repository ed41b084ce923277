"""Per-layer readers of the program's own spans: the ``gar.*`` ranges the
port records (``go_audio_resampler_tpu_torch/utils/spans.py``) while
``torch.profiler`` runs, held in the timeline among the host's events.

A span is read in each traced request: the events of its name that start
inside the request's span of the benchmark's own, their summed (inclusive)
duration and their count, each averaged over the traced requests.  The
names are written out here and nothing of the program is imported, so a
program that records no spans reads None, as a run without a trace does.
"""

from __future__ import annotations

import bisect
import statistics

#: The start of every span name the program records.
PREFIX = "gar."


def per_request(run, name: str):
    """[(summed ns, count)] of the host events named ``name`` that start
    inside each traced request's span; None where the run holds no trace,
    or a trace in which the program recorded no span."""
    tl = run.timeline
    if tl is None or not tl.spans:
        return None
    if not any(n.startswith(PREFIX) for _, _, n in tl.host):
        return None
    named = [(a, b) for a, b, n in tl.host if n == name]
    starts = [a for a, _ in named]
    out = []
    for lo, hi, _ in tl.spans:
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_left(starts, hi)
        out.append((sum(b - a for a, b in named[i:j]), j - i))
    return out


def mean_ms(run, name: str):
    """The mean over the traced requests of the summed duration, in ms,
    of the spans ``name`` inside each; None as :func:`per_request`."""
    rows = per_request(run, name)
    return None if rows is None else statistics.fmean(
        ns / 1e6 for ns, _ in rows)


def mean_count(run, name: str):
    """The mean over the traced requests of the number of spans ``name``
    inside each; None as :func:`per_request`."""
    rows = per_request(run, name)
    return None if rows is None else statistics.fmean(
        k for _, k in rows)
