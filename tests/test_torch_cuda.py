"""The port on the card: the CUDA kernels and the entry points that run
them (K1 ``fused_resample``, K2 ``fused_resample_tmajor``, K3
``general_resample``; ``EngineCore``, ``TimeMajorEngine``, ``oneshot``).

Every case needs an NVIDIA GPU: it carries the ``cuda`` marker and skips
where CUDA is not available.  This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed; from the repository
root (``--noconftest`` skips the JAX set-up of ``tests/conftest.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Oracles are the port's own plain versions, with TF32 off: the kernel is
held against its plain version in float32 to 2e-5 (summation order
differs), each entry point against its float64 CPU run to 2e-5.
"""

import importlib

import numpy as np
import pytest
import torch

from go_audio_resampler_tpu_torch import (EngineCore, Quality,
                                          TimeMajorEngine, oneshot as run_oneshot,
                                          plan_engine)
from go_audio_resampler_tpu_torch.ops import fused, general, tmajor

# engine/__init__ exports the function oneshot under the module's name.
oneshot = importlib.import_module("go_audio_resampler_tpu_torch.engine.oneshot")

TOL = 2e-5
PLANS = [(44100, 48000, Quality.HIGH), (48000, 44100, Quality.HIGH),
         (44100, 48000, Quality.VERY_HIGH)]
BLOCK = 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operator(rates_q, superframed, device):
    r, _, ipx, _ = oneshot._fused_rational_matrix(plan_engine(*rates_q))
    if superframed:
        r, ipx = oneshot.superframe(r, ipx, kf_cap=2048 // ipx)
    rt = torch.as_tensor(np.ascontiguousarray(r.T), dtype=torch.float32,
                         device=device)
    return rt, ipx, r.shape[1], r.shape[0]


def _data(s, n, device, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(s, n)).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("s,nf,rates_q", [
    (1024, 16, PLANS[0]), (5, 13, PLANS[0]), (7, 130, PLANS[1]),
    (3, 9, PLANS[2]), (1, 1, PLANS[0]),
])
def test_kernel_matches_plain_version(cuda, s, nf, rates_q):
    for superframed in (False, True):
        rt, ipx, wx, p2 = _operator(rates_q, superframed, cuda)
        x = _data(s, (nf - 1) * ipx + wx + 3, cuda, s)
        before = fused.launches
        y = fused.fused_resample(x, rt, ipx=ipx, wx=wx, p2=p2, n_frames=nf)
        torch.cuda.synchronize()
        assert fused.launches == before + 1
        ref = fused.fused_resample_reference(x, rt, ipx=ipx, wx=wx, p2=p2,
                                             n_frames=nf)
        assert y.shape == ref.shape == (s, nf * p2)
        assert (y - ref).abs().max().item() <= TOL


@pytest.mark.cuda
def test_kernel_output_bits_do_not_depend_on_the_launch(cuda):
    """One launch over 32 frames equals two launches of 16, bit for bit."""
    rt, ipx, wx, p2 = _operator(PLANS[0], False, cuda)
    x = _data(6, 31 * ipx + wx, cuda, 1)
    kw = dict(ipx=ipx, wx=wx, p2=p2)
    whole = fused.fused_resample(x, rt, n_frames=32, **kw)
    a = fused.fused_resample(x[:, :15 * ipx + wx].contiguous(), rt,
                             n_frames=16, **kw)
    b = fused.fused_resample(x[:, 16 * ipx:].contiguous(), rt, n_frames=16,
                             **kw)
    assert torch.equal(whole, torch.cat([a, b], dim=1))
    assert torch.equal(whole, fused.fused_resample(x, rt, n_frames=32, **kw))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    rt, ipx, wx, p2 = _operator(PLANS[0], False, cuda)
    x = torch.zeros((2, 15 * ipx + wx), device=cuda)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=16)
    before = fused.launches
    with pytest.raises(TypeError, match="float32"):
        fused.fused_resample(x.double(), rt.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_resample(torch.zeros((2, 2 * x.shape[1]),
                                         device=cuda)[:, ::2], rt, **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.fused_resample(x, rt.cpu(), **kw)
    with pytest.raises(ValueError, match="need data.shape"):
        fused.fused_resample(x[:, 1:].contiguous(), rt, **kw)
    assert fused.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q", PLANS)
def test_engine_matches_cpu_float64(cuda, rates_q):
    plan = plan_engine(*rates_q)
    dev = EngineCore(plan, batch=5, block=BLOCK, dtype=torch.float32)
    assert dev.device.type == "cuda"
    x = np.random.default_rng(20).normal(
        size=(5, dev.device_chunk_multiple * 60)).astype(np.float32)
    ref = EngineCore(plan, batch=5, block=BLOCK, dtype=torch.float64,
                     device="cpu")
    want = np.concatenate([ref.process(x.astype(np.float64)), ref.flush()],
                          1)
    before = fused.launches
    got = torch.cat([dev.process_device(torch.from_numpy(x).to(cuda)),
                     dev.flush_device()], 1)
    assert fused.launches > before
    assert got.device.type == "cuda" and got.shape == want.shape
    assert np.abs(got.cpu().numpy() - want).max() <= TOL
    host = EngineCore(plan, batch=5, block=BLOCK, dtype=torch.float32)
    y = np.concatenate([host.process(x[:, :1000]), host.process(x[:, 1000:]),
                        host.flush()], 1)
    assert np.array_equal(y, got.cpu().numpy())


@pytest.mark.cuda
def test_engine_on_cuda_takes_float32_only(cuda):
    with pytest.raises(ValueError, match="float32"):
        EngineCore(plan_engine(*PLANS[0]), dtype=torch.float64)


# -- K2 and K3 -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("s,nf,rates_q", [
    (1024, 16, PLANS[0]), (1000, 13, PLANS[0]), (3, 1, PLANS[0]),
    (129, 7, PLANS[2]), (37, 20, PLANS[1]),
])
def test_k2_matches_plain_version_and_k1(cuda, s, nf, rates_q):
    rt, ipx, wx, p2 = _operator(rates_q, True, cuda)
    r = rt.t().contiguous()
    xt = _data((nf - 1) * ipx + wx + 5, s, cuda, s)
    before = tmajor.launches
    y = tmajor.fused_resample_tmajor(xt, r, ipx=ipx, wx=wx, p2=p2,
                                     n_frames=nf)
    torch.cuda.synchronize()
    assert tmajor.launches == before + 1
    ref = tmajor.fused_resample_tmajor_reference(xt, r, ipx=ipx, wx=wx,
                                                 p2=p2, n_frames=nf)
    assert y.shape == ref.shape == (nf * p2, s)
    assert (y - ref).abs().max().item() <= TOL
    # The same fmaf chain as K1: bit-equal on the transposed data.
    y1 = fused.fused_resample(xt.t().contiguous(), rt, ipx=ipx, wx=wx, p2=p2,
                              n_frames=nf)
    assert torch.equal(y, y1.t())


def _k3_case(s, n_tiles, w_band, tile, n, device, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(s, n)).astype(np.float32))
    m = torch.from_numpy((rng.normal(size=(n_tiles, w_band, tile))
                          / np.sqrt(w_band)).astype(np.float32))
    starts = torch.from_numpy(np.sort(rng.integers(-3, n - w_band // 2,
                                                   size=n_tiles)))
    return x.to(device), m.to(device), starts.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n_tiles,w_band,tile,n", [
    (64, 40, 420, 256, 12000), (65, 7, 17, 200, 500), (1, 1, 300, 256, 400),
    (5, 3, 239, 256, 2000),
])
def test_k3_matches_plain_version(cuda, s, n_tiles, w_band, tile, n):
    x, m, starts = _k3_case(s, n_tiles, w_band, tile, n, cuda, s)
    ref = general.general_resample_reference(x, m, starts, w_band=w_band,
                                             tile=tile)
    for st in (starts, starts.int()):
        before = general.launches
        y = general.general_resample(x, m, st, w_band=w_band, tile=tile)
        torch.cuda.synchronize()
        assert general.launches == before + 1
        assert y.shape == ref.shape == (s, n_tiles * tile)
        assert (y - ref).abs().max().item() <= TOL


@pytest.mark.cuda
def test_k2_k3_output_bits_do_not_depend_on_the_launch(cuda):
    rt, ipx, wx, p2 = _operator(PLANS[0], False, cuda)
    r = rt.t().contiguous()
    xt = _data(31 * ipx + wx, 6, cuda, 2)
    kw = dict(ipx=ipx, wx=wx, p2=p2)
    whole = tmajor.fused_resample_tmajor(xt, r, n_frames=32, **kw)
    a = tmajor.fused_resample_tmajor(xt[:15 * ipx + wx].contiguous(), r,
                                     n_frames=16, **kw)
    b = tmajor.fused_resample_tmajor(xt[16 * ipx:].contiguous(), r,
                                     n_frames=16, **kw)
    assert torch.equal(whole, torch.cat([a, b]))
    x, m, starts = _k3_case(6, 10, 300, 256, 5000, cuda, 3)
    kw = dict(w_band=300, tile=256)
    whole = general.general_resample(x, m, starts, **kw)
    parts = [general.general_resample(x, m[i:j].contiguous(), starts[i:j],
                                      **kw) for i, j in ((0, 4), (4, 10))]
    assert torch.equal(whole, torch.cat(parts, dim=1))
    assert torch.equal(general.general_resample(x[:2].contiguous(), m,
                                                starts, **kw), whole[:2])


@pytest.mark.cuda
def test_k2_k3_reject_what_they_do_not_take(cuda):
    rt, ipx, wx, p2 = _operator(PLANS[0], False, cuda)
    r = rt.t().contiguous()
    xt = torch.zeros((15 * ipx + wx, 4), device=cuda)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=16)
    x, m, starts = _k3_case(4, 3, 20, 16, 100, cuda, 4)
    gk = dict(w_band=20, tile=16)
    before = (tmajor.launches, general.launches)
    with pytest.raises(TypeError, match="float32"):
        tmajor.fused_resample_tmajor(xt.double(), r.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tmajor.fused_resample_tmajor(
            torch.zeros((xt.shape[0], 8), device=cuda)[:, ::2], r, **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        tmajor.fused_resample_tmajor(xt, r.cpu(), **kw)
    with pytest.raises(TypeError, match="float32"):
        general.general_resample(x.double(), m.double(), starts, **gk)
    with pytest.raises(ValueError, match="contiguous"):
        general.general_resample(
            torch.zeros((4, 200), device=cuda)[:, ::2], m, starts, **gk)
    with pytest.raises(ValueError, match="one CUDA device"):
        general.general_resample(x, m, starts.cpu(), **gk)
    with pytest.raises(TypeError, match="int32 or int64"):
        general.general_resample(x, m, starts.float(), **gk)
    assert (tmajor.launches, general.launches) == before


# -- entry points ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rates_q", [PLANS[0], (48000, 16000, Quality.HIGH),
                                     (96000, 48000, Quality.VERY_HIGH)])
def test_time_major_engine_matches_cpu_float64(cuda, rates_q):
    plan = plan_engine(*rates_q)
    dev = TimeMajorEngine(plan, batch=5, block=BLOCK)
    assert dev.device.type == "cuda"
    x = np.random.default_rng(21).normal(
        size=(dev.chunk_multiple * 12, 5)).astype(np.float32)
    ref = EngineCore(plan, batch=5, block=BLOCK, dtype=torch.float64,
                     device="cpu")
    want = np.concatenate([ref.process(x.T.astype(np.float64)), ref.flush()],
                          1).T
    before = tmajor.launches
    got = torch.cat([dev.process_device(torch.from_numpy(x).to(cuda)),
                     dev.flush_device()])
    assert tmajor.launches > before
    assert got.device.type == "cuda" and got.shape == want.shape
    assert np.abs(got.cpu().numpy() - want).max() <= TOL
    stream_major = EngineCore(plan, batch=5, block=BLOCK)
    y = torch.cat([stream_major.process_device(torch.from_numpy(x.T.copy())),
                   stream_major.flush_device()], 1)
    assert torch.equal(y.t(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q,wrapper", [
    ((44100, 48000, Quality.HIGH), fused),
    ((48000, 16000, Quality.HIGH), fused),
    ((48000, 96000, Quality.HIGH), fused),
    ((44100, 48001, Quality.HIGH), general),
    ((44100, 48000, Quality.QUICK), general),
])
def test_oneshot_matches_cpu_float64(cuda, rates_q, wrapper):
    plan = plan_engine(*rates_q)
    x = np.random.default_rng(22).normal(size=(3, 5000)).astype(np.float32)
    want = run_oneshot(plan, x.astype(np.float64), device="cpu").numpy()
    before = wrapper.launches
    got = run_oneshot(plan, x)
    assert wrapper.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert got.shape == want.shape == (3, plan.lengths.canonical(5000))
    assert np.abs(got.cpu().numpy() - want).max() <= TOL
    with pytest.raises(ValueError, match="float32"):
        run_oneshot(plan, x, dtype=np.float64)
