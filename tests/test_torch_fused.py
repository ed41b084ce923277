"""PyTorch port vs JAX package: the fused banded-resample step (K1).

On the CPU the port's wrapper computes its plain version (``unfold`` +
``matmul``); it is held against the JAX package's Pallas kernel in
interpret mode and against its XLA lowering.  The CUDA kernel itself runs
only on the card: ``test_torch_cuda.py`` holds it against this plain
version there.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine import stages as jstages
from go_audio_resampler_tpu.engine import streaming as jstreaming
from go_audio_resampler_tpu.ops import pallas_fused as pf
from go_audio_resampler_tpu_torch.engine import plan as tplan
from go_audio_resampler_tpu_torch.engine import stages as tstages
from go_audio_resampler_tpu_torch.filterdesign import Quality as TQuality
from go_audio_resampler_tpu_torch.ops import _build, fused

# engine/__init__ exports the function oneshot under the module's name.
toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")

TOL = {np.float32: 2e-5, np.float64: 1e-12}
PLANS = [(44100, 48000, 3), (48000, 44100, 3), (44100, 48000, 4)]


def _operator(rates_q, superframed=False):
    """(R_t float64 [wx, p2], ipx, wx, p2) of a plan, as the engine uses it."""
    p = tplan.plan_engine(rates_q[0], rates_q[1], TQuality(rates_q[2]))
    r, p2, ipx, _ = toneshot._fused_rational_matrix(p)
    if superframed:
        r, ipx = toneshot.superframe(r, ipx, kf_cap=2048 // ipx)
    return np.ascontiguousarray(r.T), ipx, r.shape[1], r.shape[0]


def _port(x, rt, ipx, wx, p2, nf, dtype):
    return fused.fused_resample(
        torch.from_numpy(x.astype(dtype)), torch.from_numpy(rt.astype(dtype)),
        ipx=ipx, wx=wx, p2=p2, n_frames=nf, tier="highest").numpy()


@pytest.mark.parametrize("rates_q", PLANS)
def test_reference_matches_pallas_interpret(rates_q):
    rt, ipx, wx, p2 = _operator(rates_q)
    tf = pf.frame_tile_for(p2)
    nf = tf                                    # one full frame tile
    n = nf * ipx + (wx - ipx)
    x = np.random.default_rng(0).normal(size=(8, n)).astype(np.float32)
    y_j = np.asarray(pf.fused_resample_pallas(
        jnp.asarray(x), jnp.asarray(rt, dtype=jnp.float32), ipx=ipx, wx=wx,
        p2=p2, ts=8, interpret=True))
    y_t = _port(x, rt, ipx, wx, p2, nf, np.float32)
    assert y_t.shape == y_j.shape == (8, nf * p2)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(5, 13), (2, 40)])
@pytest.mark.parametrize("rates_q", PLANS)
def test_reference_matches_xla_lowering(rates_q, shape, dtype):
    s, nf = shape
    for superframed in (False, True):
        rt, ipx, wx, p2 = _operator(rates_q, superframed)
        n = (nf - 1) * ipx + wx + 7            # ragged tail, ignored
        x = np.random.default_rng(s * nf).normal(size=(s, n)).astype(dtype)
        y_j = np.asarray(jstreaming._banded_frames_apply(
            jnp.asarray(x), jnp.asarray(rt, dtype=dtype), ipx, wx, p2, nf,
            dispatch='xla'))
        y_t = _port(x, rt, ipx, wx, p2, nf, dtype)
        assert y_t.dtype == dtype and y_t.shape == y_j.shape == (s, nf * p2)
        np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL[dtype])


def test_wrapper_on_cpu_is_the_plain_version():
    rt, ipx, wx, p2 = _operator(PLANS[0])
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 15 * ipx + wx)).astype(np.float32))
    r = torch.from_numpy(rt.astype(np.float32))
    before = fused.launches
    y = fused.fused_resample(x, r, ipx=ipx, wx=wx, p2=p2, n_frames=16,
                             tier="highest")
    ref = fused.fused_resample_reference(x, r, ipx=ipx, wx=wx, p2=p2,
                                         n_frames=16, tier="highest")
    assert fused.launches == before
    assert torch.equal(y, ref)
    empty = fused.fused_resample(x, r, ipx=ipx, wx=wx, p2=p2, n_frames=0,
                                 tier="highest")
    assert empty.shape == (4, 0)


@pytest.mark.parametrize("kw,match", [
    (dict(n_frames=17), "need data.shape"),
    (dict(wx=300), "r_t is"),
    (dict(ipx=0), "ipx=0"),
    (dict(head=3, width=2000), "need width"),
    (dict(n_frames=17, head=torch.zeros((2, 100))), "need width"),
    (dict(head=torch.zeros((3, 4))), "head"),
    (dict(head=-1), "zeros"),
])
def test_wrapper_rejects_bad_shapes(kw, match):
    rt, ipx, wx, p2 = _operator(PLANS[0])
    args = dict(ipx=ipx, wx=wx, p2=p2, n_frames=16, tier="highest")
    args.update(kw)
    x = torch.zeros((2, 15 * ipx + wx))
    with pytest.raises(ValueError, match=match):
        fused.fused_resample(x, torch.zeros((wx, p2)), **args)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("c,head,extra", [
    (0, "none", 0), (0, "none", 40), (0, "none", -30), (294, "zeros", 0),
    (294, "tensor", 0), (147, "tensor", 61), (147, "tensor", -100),
    (294, "zeros", 53),
])
def test_virtual_row_is_the_cat_it_replaces(c, head, extra, dtype):
    """The plain version's virtual row ``head ++ data ++ zeros`` of
    ``width`` columns equals the ``torch.cat`` of its pieces (the carry or
    the ``lam`` zeros, the data, the flush tail's zeros), and the wrapper
    given the pieces equals the plain version on that ``cat``, bit for
    bit."""
    rt, ipx, wx, p2 = _operator(PLANS[0])
    rng = np.random.default_rng(c + abs(extra))
    n = 15 * ipx + wx - c + max(extra, 0) - 1
    data = torch.from_numpy(rng.normal(size=(3, n)).astype(dtype))
    h = {"none": None, "zeros": c,
         "tensor": torch.from_numpy(rng.normal(size=(3, c)).astype(dtype))
         }[head]
    zeros = torch.zeros((3, c), dtype=data.dtype)
    joined = torch.cat([h if head == "tensor" else zeros, data], dim=1)
    width = c + n + extra
    want = torch.cat([joined, torch.zeros((3, max(extra, 0)),
                                          dtype=data.dtype)], dim=1)[:, :width]
    got = fused.virtual_row(data, h, width)
    assert got.dtype == data.dtype and torch.equal(got, want)
    assert torch.equal(fused.virtual_row(data, h), joined)
    nf = (width - wx) // ipx + 1
    r = torch.from_numpy(rt.astype(dtype))
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=nf, tier="highest")
    y = fused.fused_resample(data, r, head=h, width=width, **kw)
    assert torch.equal(y, fused.fused_resample_reference(want, r, **kw))
    if head == "none" and extra <= 0:
        assert fused.virtual_row(data, h, width).data_ptr() == data.data_ptr()


def test_gather_windows_matches_reference():
    x = np.random.default_rng(2).normal(size=(3, 100))
    starts = np.arange(9, dtype=np.int32) * 11
    w_j = np.asarray(jstages.gather_windows(jnp.asarray(x),
                                            jnp.asarray(starts), 12))
    w_t = tstages.gather_windows(torch.from_numpy(x), 9, 11, 12)
    assert w_t.shape == (3, 9, 12)
    assert np.array_equal(w_t.numpy(), w_j)
    with pytest.raises(ValueError, match="need 101 samples"):
        tstages.gather_windows(torch.from_numpy(x), 9, 11, 13)


def test_nvcc_command_targets_hopper(monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    out = _build.library_path("fused_resample")
    cmd = _build.nvcc_command("fused_resample", out)
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-fPIC"} <= set(cmd)
    assert cmd[-1].endswith(os.path.join("csrc", "fused_resample.cu"))
    assert out.parent == _build.BUILD_DIR
    assert out.name.startswith("libfused_resample-") and out.suffix == ".so"


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_command("fused_resample", _build.BUILD_DIR / "x.so")
