"""The port on the card: the K1 CUDA kernel and the engine that runs it.

Every case needs an NVIDIA GPU: it carries the ``cuda`` marker and skips
where CUDA is not available.  This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed; from the repository
root (``--noconftest`` skips the JAX set-up of ``tests/conftest.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Oracles are the port's own plain versions, with TF32 off: the kernel is
held against ``unfold`` + ``matmul`` in float32 to 2e-5 (summation order
differs), the engine against its float64 CPU run to 2e-5.
"""

import numpy as np
import pytest
import torch

from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
from go_audio_resampler_tpu_torch.engine import oneshot
from go_audio_resampler_tpu_torch.ops import fused

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
