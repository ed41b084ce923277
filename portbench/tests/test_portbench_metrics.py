"""The readers: end-to-end metrics over all the work and time of the
window, per-layer metrics over a timeline."""

import pytest

from portbench import harness, manifest, trace


def _run(requests, timeline=None, traced=None):
    return harness.Run(cell=manifest.cell("opus48.serve"),
                       card="NVIDIA H100 80GB HBM3", setup_s=7.5,
                       requests=requests, timeline=timeline,
                       traced=traced or [])


def _req(i, t0, dur, n_in=1000, ret=None, ops=0, nbytes=0, traced=0):
    return harness.Request(i, t0, t0 + (ret or dur), t0 + dur, n_in, ops,
                           nbytes, traced)


def read(name, run, per_layer=False):
    return manifest.reader(name, per_layer).read(run)


def test_rate_is_all_work_over_the_whole_window():
    """Gaps between requests count as window time: the rate is not a
    median of per-request rates."""
    reqs = [_req(0, 0.0, 0.001), _req(1, 0.5, 0.001), _req(2, 0.6, 0.4)]
    assert read("in_msamples_per_s", _run(reqs)) == pytest.approx(
        3000 / 1.0 / 1e6)


def test_p95_is_over_every_request():
    """One slow request in twenty moves the 95th percentile; the reader
    takes each request, never an average of chunks of them."""
    reqs = [_req(i, i * 1.0, 0.001) for i in range(100)]
    for i in range(95, 100):
        reqs[i] = _req(i, i * 1.0, 0.5)
    p95 = read("latency_ms_p95", _run(reqs))
    assert p95 == pytest.approx(0.001 * 1e3 + 0.05 * (500 - 1), rel=1e-9)
    assert read("setup_s", _run(reqs)) == 7.5


def _timeline():
    ms = 1_000_000
    device = [(1 * ms, 3 * ms, "Memcpy HtoD (Pageable -> Device)"),
              (2 * ms, 4 * ms, "fused_resample_kernel<4, 0>"),
              (6 * ms, 7 * ms, "CatArrayBatchedCopy"),
              (12 * ms, 13 * ms, "fused_resample_kernel<4, 0>")]
    host = [(0, 10 * ms, trace.REQUEST_SPAN), (4 * ms, 5 * ms, "aten::cat"),
            (10 * ms, 20 * ms, trace.REQUEST_SPAN)]
    spans = [(0, 10 * ms, trace.REQUEST_SPAN),
             (10 * ms, 20 * ms, trace.REQUEST_SPAN)]
    # The last kernel's clock reads 1.5 ms late: the request that issued
    # it (at 11 ms) holds it all the same.
    origins = [1 * ms, 2 * ms, 6 * ms, 11 * ms]
    device[3] = (12 * ms, 13 * ms, device[3][2])
    return trace.Timeline(device, [trace._device_kind(d[2]) for d in device],
                          origins, host, spans)


def test_layer_readers_on_a_timeline():
    tl = _timeline()
    ms = 1_000_000
    assert tl.busy_ns(0, 20 * ms) == 5 * ms      # union, overlap once
    reqs = [_req(0, 0.0, 0.010, ops=10**9, nbytes=10**6, traced=1),
            _req(1, 0.010, 0.010, ops=10**9, nbytes=10**6, traced=1)]
    # Outside the trace: steps of 8 and 6 ms on the host clock.
    after = [_req(2, 0.020, 0.008), _req(3, 0.028, 0.006)]
    run = _run(reqs + after, tl, reqs)
    assert read("device.idle_share.serve", run, True) == pytest.approx(0.75)
    assert read("copies.device_ms_per_step.serve", run, True) == \
        pytest.approx(1.0)
    # The untraced steps' mean, 7 ms, less the device time that a traced
    # step issued, (5 + 1) / 2 ms: the traced spans' own 10 ms are not read.
    assert read("engine.host_ms_per_step.serve", run, True) == \
        pytest.approx(7 - (5 + 1) / 2)
    assert read("step.other_kernels_ms_per_step.bulk", run, True) == \
        pytest.approx(0.5)
    # 2e9 operations at 165 TFLOP/s over 4 ms of kernels.
    assert read("kernels.roofline_pct.bulk", run, True) == pytest.approx(
        100 * 2e9 / 165e12 / 4e-3)
    gaps = dict(tl.idle_gaps())
    assert gaps["aten::cat"] == pytest.approx(0.002)
    assert sum(gaps.values()) == pytest.approx(0.015)
    assert tl.device_ops()[0][0] == "fused_resample_kernel<4, 0>"


def test_readers_find_nothing_without_a_trace():
    run = _run([_req(0, 0.0, 0.01)])
    for m in manifest.load()["per_layer"]:
        if m["source"] != "host_clock":
            assert read(m["name"], run, True) is None


def test_step_p95_is_over_the_untraced_steps():
    """The tail of the untraced steps; the traced ones, slowed by the
    profiler, are not read, and a run with none outside the trace has no
    reading."""
    traced = [_req(i, i * 0.1, 0.09, traced=1) for i in range(5)]
    after = [_req(i, i * 0.1, 0.001) for i in range(5, 105)]
    for r in after[-5:]:
        r.t_done = r.t_call + 0.011
    run = _run(traced + after, None, traced)
    assert read("engine.step_ms_p95.serve", run, True) == pytest.approx(
        1.0 + 0.05 * (11.0 - 1.0), rel=1e-9)
    assert read("engine.step_ms_p95.serve", _run(traced, None, traced),
                True) is None


def test_oneshot_host_time_is_call_to_return():
    """Call to return, over the requests outside the trace: the traced
    ones, slowed by the profiler, are not read."""
    traced = [_req(i, i * 0.01, 0.009, ret=0.007, traced=1)
              for i in range(2)]
    reqs = traced + [_req(i, i * 0.01, 0.008, ret=0.003)
                     for i in range(2, 6)]
    assert read("oneshot.host_ms_per_call.varlen", _run(reqs, None, traced),
                True) == pytest.approx(3.0)
