"""The readers of the program's own spans (``portbench/spans.py``): each
sums and counts the spans of its name that start inside each request."""

import pytest

from portbench import harness, manifest, trace

MS = 1_000_000
#: metric -> (the span it reads, whether it counts the spans)
READERS = {
    "engine.fifo_ms_per_step.serve": ("gar.engine.fifo", False),
    "engine.emit_ms_per_step.serve": ("gar.engine.emit", False),
    "copies.h2d_host_ms_per_step.serve": ("gar.engine.h2d", False),
    "copies.d2h_host_ms_per_step.serve": ("gar.engine.d2h", False),
    "step.enqueue_ms_per_step.serve": ("gar.engine.step", False),
    "oneshot.aux_ms_per_call.varlen": ("gar.oneshot.aux", False),
    "oneshot.aux_builds_per_call.varlen": ("gar.oneshot.aux", True),
}


def _run(timeline):
    return harness.Run(cell=manifest.cell("opus48.serve"),
                       card="NVIDIA H100 80GB HBM3", setup_s=7.5,
                       requests=[], timeline=timeline, traced=[])


def _timeline(host):
    """Two requests, [0, 10) and [10, 20) ms, one kernel, and ``host``
    besides the request spans."""
    spans = [(0, 10 * MS, trace.REQUEST_SPAN),
             (10 * MS, 20 * MS, trace.REQUEST_SPAN)]
    device = [(2 * MS, 3 * MS, "fused_resample_kernel<4, 0>")]
    return trace.Timeline(device, ["kernel"], [2 * MS], sorted(host + spans),
                          spans)


def _read(metric, timeline):
    return manifest.reader(metric, True).read(_run(timeline))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_the_spans_that_start_in_each_request(metric):
    """Request 0 holds two spans of the name (0.5 and 0.25 ms), request 1
    one of 1 ms and one that starts in it and ends after it (1 ms, read
    whole); a span before the first request, one after the last and
    spans of other names are not read."""
    name, count = READERS[metric]
    other = "gar.engine.other"
    host = [(-2 * MS, -1 * MS, name),
            (0, 10 * MS, "gar.engine.process"),
            (1 * MS, int(1.5 * MS), name),
            (int(1.5 * MS), 4 * MS, other),
            (3 * MS, int(3.25 * MS), name),
            (10 * MS, 20 * MS, "gar.engine.process"),
            (12 * MS, 13 * MS, name),
            (14 * MS, 18 * MS, other),
            (int(19.5 * MS), int(20.5 * MS), name),
            (25 * MS, 30 * MS, name)]
    want = (2 + 2) / 2 if count else (0.75 + 2.0) / 2
    assert _read(metric, _timeline(host)) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_zero_where_the_program_records_spans_but_none_of_the_name(
        metric):
    """A call whose set-up the cache held records no ``gar.oneshot.aux``:
    0 ms and 0 builds, not None."""
    host = [(0, 10 * MS, "gar.functional.resample"),
            (10 * MS, 20 * MS, "gar.functional.resample")]
    assert _read(metric, _timeline(host)) == 0.0


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_none_without_the_programs_spans(metric):
    """A program that records no span (a parent before the spans) and a
    run without a trace read None."""
    host = [(1 * MS, 2 * MS, "aten::cat")]
    assert _read(metric, _timeline(host)) is None
    assert _read(metric, None) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_manifest_entries(metric):
    entry = next(m for m in manifest.load()["per_layer"]
                 if m["name"] == metric)
    assert entry["source"] == "program_span"
    assert entry["workloads"] == (["whisper16.varlen"] if "varlen" in metric
                                  else ["opus48.serve"])
    assert entry["unit"] == ("builds" if READERS[metric][1] else "ms")
