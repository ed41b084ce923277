"""Each cell's traffic cut to a size that a CPU test run holds."""

SMALL = {
    "opus48.serve": dict(streams=16, pool_requests=6, warmup_requests=3,
                         sample_streams=4, sample_requests=6,
                         trace_seconds=0.2),
    "opus48.bulk": dict(streams=8, request_seconds=0.02, pool_requests=3,
                        warmup_requests=2, sample_streams=4,
                        sample_requests=4, trace_seconds=0.2),
    "whisper16.clips": dict(batch=4, lengths={"kind": "fixed",
                                              "seconds": 0.25},
                            pool_requests=2, warmup_requests=2,
                            sample_streams=2, sample_requests=4,
                            trace_seconds=0.2),
    "whisper16.varlen": dict(batch_seconds=1.6, lengths={
        "kind": "log_uniform", "min_seconds": 0.05, "max_seconds": 0.4,
        "strata": 8}, warmup_requests=3, sample_streams=2,
        sample_requests=4, trace_seconds=0.2),
}
CELLS = sorted(SMALL)
STREAMING = ["opus48.bulk", "opus48.serve"]
SEED = 2**33 + 17


def run(cell, seconds=0.3, trace=False, **kw):
    from portbench import harness
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides=SMALL[cell], log=lambda line: None,
                            **kw)
