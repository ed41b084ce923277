"""The plain reference against the port on the CPU, in float64 at a tiny
size, through each cell's entry; and its parts on their own."""

import numpy as np
import pytest
import torch

from portbench.reference import design, resample as ref

TS = design.design(44100.0, 48000.0, "HIGH")
DEC = design.design(48000.0, 16000.0, "HIGH")


def _x_of(x):
    def x_of(a, b):
        out = torch.zeros((x.shape[0], b - a), dtype=torch.float64)
        lo, hi = max(a, 0), min(b, x.shape[1])
        if hi > lo:
            out[:, lo - a:hi - a] = x[:, lo:hi]
        return out
    return x_of


def test_designs_have_the_configurations_taps():
    assert isinstance(TS, design.TwoStage) and isinstance(DEC,
                                                          design.Decimation)
    assert TS.pre.shape == (2, 166) and TS.bank.shape == (80, 64)
    assert TS.step >> 16 == 147 and TS.step & 0xFFFF == 0
    assert DEC.factor == 3 and len(DEC.coeffs) == 1349


@pytest.mark.parametrize("device_route", [False, True])
def test_stream_equals_engine_core(device_route):
    """``EngineCore.process`` (opus48.serve's entry) and
    ``process_device`` (opus48.bulk's) against the reference's stream,
    every emitted output at its place, over steps of 882 samples."""
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    x = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (3, 882 * 9)))
    eng = EngineCore(plan_engine(44100.0, 48000.0, Quality.HIGH), batch=3,
                     block=882, dtype=torch.float64, device="cpu")
    ys, fed = [], 0
    for i in range(9):
        blk = x[:, i * 882:(i + 1) * 882]
        y = (eng.process_device(blk) if device_route
             else torch.as_tensor(eng.process(blk.numpy())))
        fed += 882
        ys.append(y)
        # Every output due before this step has come by its end.
        assert sum(t.shape[1] for t in ys) >= ref.due(TS, fed - 882)
    y = torch.cat(ys, dim=1)
    want = ref.stream(_x_of(x), TS, 0, y.shape[1])
    assert float((y - want).abs().max()) < 1e-12
    assert y.shape[1] <= ref.due(TS, fed)


@pytest.mark.parametrize("n", [1349, 4801, 48000 + 7])
def test_decimation_equals_functional(n):
    """``functional.resample`` (the whisper16 cells' entry): values and the
    canonical length."""
    from go_audio_resampler_tpu_torch import functional
    x = torch.as_tensor(np.random.default_rng(n).uniform(-1, 1, (2, n)))
    y = functional.resample(x, 48000, 16000, device="cpu")
    want = ref.decimate(x, DEC)
    assert y.shape == want.shape
    assert float((y - want).abs().max()) < 1e-12


def test_decimation_length_equals_the_ports():
    from go_audio_resampler_tpu_torch import plan_engine, Quality
    lm = plan_engine(48000.0, 16000.0, Quality.HIGH).lengths
    for n in list(range(0, 3000, 7)) + [1440000, 1680000, 96001]:
        assert ref.decimation_length(n, 3, 1349) == lm.canonical(n)


def test_stream_of_a_later_range_equals_the_whole():
    x = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, (2, 30000)))
    whole = ref.stream(_x_of(x), TS, 0, 5000)
    part = ref.stream(_x_of(x), TS, 3333, 5000)
    assert float((whole[:, 3333:] - part).abs().max()) < 1e-13
    d = ref.stream(_x_of(x), DEC, 100, 900)
    assert float((ref.decimate(x, DEC)[:, 100:900] - d).abs().max()) < 1e-13


def test_tf32_round():
    t = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 3.1415926, -2.5e-3])
    r = ref.tf32_round(t)
    assert r[0] == 1.0 and r[2] == 1.0 + 2**-10
    assert r[1] in (1.0, 1.0 + 2**-10)
    m = r.view(torch.int32) & 0x1FFF
    assert int(m.abs().max()) == 0
    assert float(((r - t) / t).abs().max()) <= 2**-11
