"""PyTorch port vs JAX package: the differentiable ``functional.resample``.

The port runs on ``device='cpu'`` (its kernels' plain versions) in float64
against the JAX package's ``functional.resample`` on the CPU: outputs and
``jax.grad`` gradients within 1e-12, lengths equal.  Carried over from
``tests/test_functional.py``: parity with ``resample_mono``, the length
helper, leading axes, the adjoint identity ``<R x, y> = <x, R^T y>``, the
finite-difference check, a training step, and the scan path's adjoint;
added: ``torch.autograd.gradcheck``, the forward equal to ``oneshot`` bit
for bit on the exact plans, and a spy showing that the scan path builds no
per-length matrices.  (The JAX cases of ``jit``, ``vmap`` and
``shard_map`` have no counterpart here.)  The card's cases are in
``test_torch_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_audio_resampler_tpu as jar
import go_audio_resampler_tpu_torch as tar
from go_audio_resampler_tpu import functional as jfunctional
from go_audio_resampler_tpu_torch import functional

toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")

TOL = 1e-12
RNG = np.random.default_rng(0xF0)

CASES = [
    (44100.0, 48000.0, 3),      # fused rational
    (48000.0, 44100.0, 4),
    (96000.0, 48000.0, 3),      # integer decimation
    (48000.0, 96000.0, 2),      # dft_up
    (44100.0, 48000.0, 0),      # cubic
    (44100.0, 48001.0, 3),      # non-exact rational
]
EXACT = [c for c in CASES if c[2] != 0 and c[1] != 48001.0]
IDS = [f"{int(a)}-{int(b)}-q{q}" for a, b, q in CASES]


def resample(x, inr, outr, q=3, **kw):
    kw.setdefault("device", "cpu")
    return tar.resample(x, inr, outr, quality=tar.QualityPreset(q), **kw)


def jresample(x, inr, outr, q=3, **kw):
    return jar.resample(x, inr, outr, quality=jar.QualityPreset(q), **kw)


@pytest.mark.parametrize("inr,outr,q", CASES, ids=IDS)
def test_matches_jax(inr, outr, q):
    x = RNG.normal(size=(2, 1700)) * 0.5
    want = np.asarray(jresample(jnp.asarray(x), inr, outr, q))
    got = resample(torch.from_numpy(x), inr, outr, q)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert (functional.output_length(1700, inr, outr, tar.QualityPreset(q))
            == jfunctional.output_length(1700, inr, outr,
                                         jar.QualityPreset(q)))


@pytest.mark.parametrize("inr,outr,q", CASES, ids=IDS)
def test_grad_matches_jax(inr, outr, q):
    x = RNG.normal(size=(2, 900)) * 0.5
    m = functional.output_length(900, inr, outr, tar.QualityPreset(q))
    w = RNG.normal(size=(2, m))
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jresample(v, inr, outr, q) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(
        (resample(xt, inr, outr, q) * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("inr,outr,q", CASES, ids=IDS)
def test_matches_resample_mono(inr, outr, q):
    x = RNG.normal(size=3000) * 0.5
    y = resample(x, inr, outr, q, dtype=torch.float64)
    ref = tar.resample_mono(x, inr, outr, quality=tar.QualityPreset(q),
                            device="cpu")
    assert tuple(y.shape) == ref.shape
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("inr,outr,q", EXACT)
def test_exact_plans_equal_oneshot(inr, outr, q, dtype):
    """Exact-rational, decimation and dft_up plans run the one-shot's
    operator: the forward is ``oneshot``'s output bit for bit."""
    x = (RNG.normal(size=(3, 1500)) * 0.5).astype(dtype)
    y = resample(x, inr, outr, q)
    plan = functional._plan(inr, outr, tar.QualityPreset(q))
    ref = tar.oneshot(plan, x, device="cpu")
    assert y.dtype == ref.dtype
    assert torch.equal(y, ref)


def test_output_length_helper():
    for inr, outr, q in CASES:
        n = 2111
        m = functional.output_length(n, inr, outr, tar.QualityPreset(q))
        y = resample(RNG.normal(size=n), inr, outr, q)
        assert tuple(y.shape) == (m,)


def test_leading_axes_restored():
    x = RNG.normal(size=(2, 3, 1000)).astype(np.float32)
    y = resample(x, 48000, 44100)
    m = functional.output_length(1000, 48000, 44100)
    assert tuple(y.shape) == (2, 3, m) and y.dtype == torch.float32
    one = resample(x[1, 2], 48000, 44100)
    torch.testing.assert_close(y[1, 2], one, rtol=1e-6, atol=1e-7)
    assert tuple(resample(np.zeros((0, 1000)), 48000, 44100).shape) == (0, m)
    with pytest.raises(ValueError, match="axis"):
        resample(np.float64(1.0), 48000, 44100)


def test_compute_dtype_and_result_dtype():
    x64 = torch.from_numpy(RNG.normal(size=(1, 800)))
    # An explicit float32 compute dtype; the result is cast back.
    y = resample(x64, 44100, 48000, dtype=np.float32)
    assert y.dtype == torch.float64
    ref = resample(x64.float(), 44100, 48000)
    assert torch.equal(y, ref.double())
    # Integer input computes float32 (the default on the card, and the
    # CPU's for non-float input) and returns it.
    yi = resample(torch.arange(800).reshape(1, 800), 44100, 48000)
    assert yi.dtype == torch.float32


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tar.resample(np.zeros(100), 44100, 48000)


@pytest.mark.parametrize("inr,outr,q", [
    (44100.0, 48000.0, 3),
    (96000.0, 48000.0, 3),
    (44100.0, 48000.0, 0),
    (44100.0, 48001.0, 2),
])
def test_adjoint_identity(inr, outr, q):
    n = 700
    m = functional.output_length(n, inr, outr, tar.QualityPreset(q))
    x = torch.from_numpy(RNG.normal(size=(1, n))).requires_grad_()
    y = torch.from_numpy(RNG.normal(size=(1, m)))
    rx = resample(x, inr, outr, q, dtype=torch.float64)
    (xbar,) = torch.autograd.grad(rx, x, y)
    lhs = float((rx.detach() * y).sum())
    rhs = float((x.detach() * xbar).sum())
    assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs)), (lhs, rhs)


@pytest.mark.parametrize("inr,outr,q", [
    (44100.0, 48000.0, 3),
    (48000.0, 16000.0, 3),
    (48000.0, 96000.0, 3),
    (44100.0, 48000.0, 0),
    (44100.0, 48001.0, 3),
])
def test_gradcheck(inr, outr, q):
    x = torch.from_numpy(RNG.normal(size=(1, 60))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: resample(v, inr, outr, q), (x,), eps=1e-6, atol=1e-7)


def test_grad_matches_finite_difference():
    n = 400
    x = torch.from_numpy(RNG.normal(size=n))
    w = torch.from_numpy(RNG.normal(
        size=functional.output_length(n, 44100, 48000)))

    def loss(v):
        return (resample(v, 44100, 48000, dtype=torch.float64) * w).sum()

    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(xg), xg)
    # A linear op: the directional derivative is exact; compare with a
    # central difference along a random direction.
    d = torch.from_numpy(RNG.normal(size=n))
    eps = 1e-3
    fd = float((loss(x + eps * d) - loss(x - eps * d)) / (2 * eps))
    assert abs(float((g * d).sum()) - fd) < 1e-6 * max(1.0, abs(fd))


def test_training_step_reduces_loss():
    """The advertised use: gradients through ingest resampling reach a
    learnable front end, and a few optimizer steps reduce its loss."""
    torch.manual_seed(0)
    n = 1200
    x = torch.randn((4, 1, n))
    target = resample(torch.tanh(0.7 * x[:, 0]), 48000, 16000)
    front = torch.nn.Conv1d(1, 1, 9, padding=4)
    opt = torch.optim.Adam(front.parameters(), lr=0.05)
    losses = []
    for _ in range(5):
        y = resample(torch.tanh(front(x)[:, 0]), 48000, 16000)
        loss = ((y - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert front.weight.grad is not None
    assert float(front.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("inr,outr,q", [
    (44100.0, 48001.0, 3),      # non-exact rational
    (44100.0, 48000.0, 0),      # cubic
])
def test_scan_path_builds_no_length_matrices(inr, outr, q, monkeypatch):
    """The block loop's constants are the coefficient banks: neither
    direction builds the one-shot's per-length tile matrices."""
    def boom(*a, **k):
        raise AssertionError("per-length matrices built")
    monkeypatch.setattr(toneshot, "_general_matrices", boom)
    monkeypatch.setattr(toneshot, "_cubic_matrices", boom)
    x = torch.from_numpy(RNG.normal(size=(2, 3000))).requires_grad_()
    y = resample(x, inr, outr, q)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert tuple(y.shape) == (2, functional.output_length(
        3000, inr, outr, tar.QualityPreset(q)))
    assert torch.isfinite(g).all()


def test_adjoint_still_exact_on_scan_path():
    inr, outr, q = 44100.0, 48001.0, 3
    n = 5000
    m = functional.output_length(n, inr, outr)
    x = torch.from_numpy(RNG.normal(size=(2, n))).requires_grad_()
    y = torch.from_numpy(RNG.normal(size=(2, m)))
    rx = resample(x, inr, outr, q, dtype=torch.float64)
    (xbar,) = torch.autograd.grad(rx, x, y)
    lhs = float((rx.detach() * y).sum())
    rhs = float((x.detach() * xbar).sum())
    assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs)), (lhs, rhs)
