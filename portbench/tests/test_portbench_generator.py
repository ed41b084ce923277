"""The generator: the same seed gives the same inputs, sizes and samples;
each mix's blocks are whole steps of its engine."""

import pytest
import torch

from portbench import generator, manifest
from portbench.tests.small import SEED

SEEDS = [0, 7, 2**31 + 5, 2**40 + 3, -12]


@pytest.mark.parametrize("seed", SEEDS)
def test_noise_repeats_for_a_seed(seed):
    a = generator.noise((3, 1000), seed, 1, "cpu")
    b = generator.noise((3, 1000), seed, 1, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert -1.0 <= float(a.min()) and float(a.max()) < 1.0
    assert not torch.equal(a, generator.noise((3, 1000), seed + 1, 1, "cpu"))
    assert not torch.equal(a, generator.noise((3, 1000), seed, 2, "cpu"))


@pytest.mark.parametrize("seed", SEEDS)
def test_lengths_rows_and_sample_repeat_for_a_seed(seed):
    spec = manifest.cell("whisper16.varlen").traffic["lengths"]
    f, longest, shortest = generator.lengths(spec, 48000, seed)
    g, _, _ = generator.lengths(spec, 48000, seed)
    seq = [f(i) for i in range(300)]
    assert seq == [g(i) for i in range(300)]
    assert all(shortest <= n <= longest for n in seq)
    assert generator.stratified_rows(64, 4, seed) == \
        generator.stratified_rows(64, 4, seed)
    picks = []
    for _ in range(2):
        r = generator.Reservoir(5, seed)
        picks.append([i for i in range(100) if r.slot(i)
                      and not r.kept.__setitem__(i, i)])
    assert picks[0] == picks[1]


def test_log_uniform_lengths_are_stratified():
    """Each block of ``strata`` requests holds one length from each slice
    of the log range, so every seed asks for the same work a block."""
    spec = {"kind": "log_uniform", "min_seconds": 2, "max_seconds": 35,
            "strata": 64}
    sums = []
    for seed in (1, 2, 3):
        f, _, _ = generator.lengths(spec, 48000, seed)
        block = [f(i) for i in range(64)]
        assert len(set(block)) == 64
        sums.append(sum(block))
    assert max(sums) / min(sums) < 1.02


def test_stratified_rows_take_one_from_each_slice():
    rows = generator.stratified_rows(1024, 8, SEED)
    assert [r // 128 for r in rows] == list(range(8))


@pytest.mark.parametrize("cell", ["opus48.serve", "opus48.bulk"])
def test_blocks_are_whole_steps(cell):
    """A frame (882) and a block (44,100) are multiples of the engine's
    ``device_chunk_multiple`` (147) and are one step each."""
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    c = manifest.cell(cell)
    width = generator.samples(c.traffic["request_seconds"],
                              c.config["input_rate"])
    plan = plan_engine(44100.0, 48000.0, Quality[c.config["quality"]])
    eng = EngineCore(plan, batch=2, block=width, device="cpu")
    assert eng.device_chunk_multiple == 147
    assert width % 147 == 0 and eng.block == width
    assert width in (882, 44100)


def test_a_duration_that_is_no_whole_number_of_samples_is_refused():
    with pytest.raises(ValueError):
        generator.samples(0.00001, 44100)


def test_duration_batches_fill_their_budget():
    """``whisper16.varlen``'s batches: as many clips of the request's length
    as ``batch_seconds`` of audio holds, every one a view into the pool,
    with the sampled clips spread over the whole batch."""
    from portbench.entries import functional
    from portbench.harness import Context
    from portbench.tests.small import SMALL
    c = manifest.cell("whisper16.varlen")
    traffic = {**c.traffic, **SMALL["whisper16.varlen"]}
    ctx = Context(config=c.config, traffic=traffic, seed=SEED,
                  device=torch.device("cpu"), tier="highest", filters=None)
    drv = functional.Driver(ctx)
    budget = generator.samples(traffic["batch_seconds"], 48000)
    for i in range(40):
        drv.prepare(i)
        off, n, b = drv._clip
        assert b == budget // n and budget - n < b * n <= budget
        assert drv._x.shape == (b, n) and off + b * n <= drv.pool.numel()
        rows = drv._rows(b)
        assert len(rows) == traffic["sample_streams"] and rows[-1] >= b // 2
