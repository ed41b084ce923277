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
differs; K1, K2 and K3 compute in three TF32 passes on the tensor cores),
each entry point against its float64 CPU run to 2e-5.
"""

import importlib

import numpy as np
import pytest
import torch

from go_audio_resampler_tpu_torch import (EngineCore, Quality,
                                          TimeMajorEngine, oneshot as run_oneshot,
                                          plan_engine)
from go_audio_resampler_tpu_torch.ops import (banded, convolve, fused,
                                              general, tmajor)

# engine/__init__ exports the function oneshot under the module's name.
oneshot = importlib.import_module("go_audio_resampler_tpu_torch.engine.oneshot")
streaming = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.streaming")

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
        y = fused.fused_resample(x, rt, ipx=ipx, wx=wx, p2=p2, n_frames=nf,
                                 op=banded.prepare(rt, tier="highest"),
                                 tier="highest")
        torch.cuda.synchronize()
        assert fused.launches == before + 1
        ref = fused.fused_resample_reference(x, rt, ipx=ipx, wx=wx, p2=p2,
                                             n_frames=nf, tier="highest")
        assert y.shape == ref.shape == (s, nf * p2)
        assert (y - ref).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernels_take_rows_that_start_off_a_16_byte_boundary(cuda, offset):
    """K1 stages 16-byte chunks from each row's own 16-byte boundary: a
    contiguous view that starts ``offset`` floats into its storage gives
    the bits of an aligned copy.  K2 stages 4 bytes at a time where the
    row stride is not a multiple of 4 floats, with the same bits."""
    rt, ipx, wx, p2 = _operator(PLANS[0], False, cuda)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=9,
              op=banded.prepare(rt, tier="highest"), tier="highest")
    n = 8 * ipx + wx
    store = _data(1, offset + 6 * n, cuda, offset).reshape(-1)
    x = store[offset:].view(6, n)
    assert x.is_contiguous() and x.data_ptr() % 16
    y = fused.fused_resample(x, rt, **kw)
    assert torch.equal(y, fused.fused_resample(x.clone(), rt, **kw))
    ref = fused.fused_resample_reference(x, rt, ipx=ipx, wx=wx, p2=p2,
                                         n_frames=9, tier="highest")
    assert (y - ref).abs().max().item() <= TOL
    xt = _data(n, 4 + offset, cuda, 9)                   # ld % 4 != 0
    yt = tmajor.fused_resample_tmajor(xt, rt.t().contiguous(), **kw)
    assert torch.equal(yt, fused.fused_resample(xt.t().contiguous(), rt,
                                                **kw).t())


@pytest.mark.cuda
def test_kernel_output_bits_do_not_depend_on_the_launch(cuda):
    """One launch over 32 frames equals two launches of 16, bit for bit."""
    rt, ipx, wx, p2 = _operator(PLANS[0], False, cuda)
    x = _data(6, 31 * ipx + wx, cuda, 1)
    kw = dict(ipx=ipx, wx=wx, p2=p2, op=banded.prepare(rt, tier="highest"),
              tier="highest")
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
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=16, tier="highest")
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
    with pytest.raises(ValueError, match="need width"):
        fused.fused_resample(x, rt, width=15 * ipx + wx - 1, **kw)
    with pytest.raises(ValueError, match="need width"):
        fused.fused_resample(x[:, 100:], rt, head=99, **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.fused_resample(x, rt, head=torch.zeros((2, 3)), **kw)
    with pytest.raises(ValueError, match="op=banded.prepare"):
        fused.fused_resample(x, rt, **kw)             # R not prepared
    assert fused.launches == before


def _rows_at(s, n, offset, pad, device, seed):
    """[s, n] float32 rows at row stride n + pad (0 with pad None: one row
    broadcast), starting ``offset`` floats into their storage."""
    ld = 0 if pad is None else n + pad
    store = _data(1, offset + max(s * ld, n), device, seed).reshape(-1)
    return store[offset:].as_strided((s, n), (ld, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
@pytest.mark.parametrize("which", ["main", "decim"])
@pytest.mark.parametrize("c", [0, 147, 294])
def test_k1_reads_head_data_and_zeros_in_place(cuda, tier, which, c):
    """K1 with ``head`` and ``width`` equals K1 on the materialised row
    head ++ data ++ zeros, bit for bit, at the main operator (split 1) and
    the decimation operator (split 8): heads of 0, 147 and 294 samples
    (294: the CD->DAT carry) as zeros, as a tensor off the data's skew and
    as one laid out at it (``streaming._next_carry``), so frames across
    the head's end; data that ends mid-frame and mid-chunk, before the
    last frames start, that covers the frames, and that runs past them;
    data and head 1-3 floats off a 16-byte boundary at row strides not a
    multiple of 4, and one row broadcast.  ``inplace_launches`` counts the
    launches with a head or a zero tail, and nothing else."""
    rt, ipx, wx, p2 = (_decim_operator(cuda) if which == "decim"
                       else _operator(PLANS[0], False, cuda))
    op = banded.prepare(rt, tier)
    assert op.split == (8 if which == "decim" else 1)
    s, nf = 37, 5
    width = (nf - 1) * ipx + wx
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=nf, op=op, tier=tier)
    # zeros past the data; the last two: the last frame starts 2 taps past
    # it, and the last two frames start past it
    for tail in (0, 1, 3, ipx // 2 + 2, ipx + 5, -7, wx + 2, wx + ipx + 3):
        n = width - c - tail
        for offset, pad in ((0, 0), (1, 3), (2, 1), (3, 6), (1, None)):
            data = _rows_at(s, n, offset, pad, cuda, offset + abs(tail))
            off_skew = _rows_at(s, c, (offset + 1) % 4, (pad or 0) + 1, cuda,
                                7 + abs(tail))
            at_skew = streaming._next_carry(off_skew, data).copy_(off_skew)
            heads = [None] if c == 0 else [c, off_skew, at_skew]
            for head in heads:
                row = fused.virtual_row(data, head, width).contiguous()
                want = fused.fused_resample(row, rt, **kw)
                before = (fused.launches, fused.inplace_launches)
                got = fused.fused_resample(data, rt, head=head, width=width,
                                           **kw)
                engaged = int(c > 0 or tail > 0)
                assert (fused.launches, fused.inplace_launches) == (
                    before[0] + 1, before[1] + engaged)
                label = (tail, offset, pad, type(head).__name__)
                assert torch.equal(got, want), label
        plain = {k: v for k, v in kw.items() if k != "op"}
        ref = fused.fused_resample_reference(data, rt, head=head, width=width,
                                             **plain)
        assert _rel_err(got, ref) <= TOL, tail


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
    op = banded.prepare(rt, tier="highest")
    y = tmajor.fused_resample_tmajor(xt, r, ipx=ipx, wx=wx, p2=p2,
                                     n_frames=nf, op=op, tier="highest")
    torch.cuda.synchronize()
    assert tmajor.launches == before + 1
    ref = tmajor.fused_resample_tmajor_reference(xt, r, ipx=ipx, wx=wx,
                                                 p2=p2, n_frames=nf,
                                                 tier="highest")
    assert y.shape == ref.shape == (nf * p2, s)
    assert (y - ref).abs().max().item() <= TOL
    # The same fmaf chain as K1: bit-equal on the transposed data.
    y1 = fused.fused_resample(xt.t().contiguous(), rt, ipx=ipx, wx=wx, p2=p2,
                              n_frames=nf, op=op, tier="highest")
    assert torch.equal(y, y1.t())


def _k3_case(s, n_tiles, w_band, tile, n, device, seed, band=None):
    """x, M, starts and M's band table; with ``band`` = (lo, width) tap
    column p's non-zero taps are lo + p//2 + [0, width) (a narrow
    diagonal band, zeros elsewhere)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(s, n)).astype(np.float32))
    m = rng.normal(size=(n_tiles, w_band, tile)) / np.sqrt(w_band)
    if band is not None:
        lo, width = band
        w = np.arange(w_band)[:, None] - lo - np.arange(tile)[None, :] // 2
        m = m * ((w >= 0) & (w < width))
    m = torch.from_numpy(m.astype(np.float32))
    starts = torch.from_numpy(np.sort(rng.integers(-3, n - w_band // 2,
                                                   size=n_tiles)))
    return (x.to(device), m.to(device), starts.to(device),
            general.band_table(m).to(device))


def _k3_oneshot(name, device):
    """(starts, M, bands, warpgroups) of the one-shot path's K3 at 2 s of
    44.1 kHz: 44.1k -> 48.001k HIGH (general) or 44.1k -> 48k QUICK
    (cubic)."""
    rates_q = {"general": (44100, 48001, Quality.HIGH),
               "cubic": (44100, 48000, Quality.QUICK)}[name]
    plan = plan_engine(*rates_q)
    count = plan.lengths.canonical(88200)
    build = (oneshot._cubic_matrices if plan.kind == "cubic"
             else oneshot._general_matrices)
    return oneshot._upload(build(plan, count), torch.float32, device)


@pytest.mark.cuda
@pytest.mark.parametrize("warpgroups", [1, 2])
@pytest.mark.parametrize("s,n_tiles,w_band,tile,n,band", [
    (64, 40, 420, 256, 12000, None), (65, 7, 17, 200, 500, None),
    (1, 1, 300, 256, 400, None), (5, 3, 239, 256, 2000, None),
    (66, 9, 300, 512, 4000, (40, 12)), (3, 5, 61, 20, 900, (3, 5)),
    (9, 4, 37, 30, 601, None),
])
def test_k3_matches_plain_version(cuda, s, n_tiles, w_band, tile, n, band,
                                  warpgroups):
    x, m, starts, bands = _k3_case(s, n_tiles, w_band, tile, n, cuda, s,
                                   band)
    ref = general.general_resample_reference(x, m, starts, w_band=w_band,
                                             tile=tile, tier="highest")
    for st in (starts, starts.int()):
        before = general.launches
        y = general.general_resample(x, m, st, w_band=w_band, tile=tile,
                                     bands=bands, warpgroups=warpgroups,
                                     tier="highest")
        torch.cuda.synchronize()
        assert general.launches == before + 1
        assert y.shape == ref.shape == (s, n_tiles * tile)
        assert (y - ref).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("warpgroups", [1, 2])
def test_k3_reads_m_only_within_its_bands(cuda, warpgroups):
    """Values of M outside its band table are never read: poisoned with
    NaN there, M gives the clean matrix's bits."""
    x, m, starts, bands = _k3_case(7, 6, 200, 256, 3000, cuda, 12, (30, 9))
    kw = dict(w_band=200, tile=256, bands=bands, warpgroups=warpgroups,
              tier="highest")
    want = general.general_resample(x, m, starts, **kw)
    b = bands.cpu().numpy()
    inside = np.zeros(tuple(m.shape), bool)
    for t in range(m.shape[0]):
        for nb, (lo, hi) in enumerate(b[t]):
            inside[t, 8 * lo:8 * hi, 8 * nb:8 * nb + 8] = True
    poisoned = torch.where(torch.from_numpy(inside).to(cuda), m,
                           torch.tensor(float("nan"), device=cuda))
    assert torch.equal(general.general_resample(x, poisoned, starts, **kw),
                       want)
    assert (want - general.general_resample_reference(
        x, m, starts, w_band=200, tile=256,
        tier="highest")).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["general", "cubic"])
@pytest.mark.parametrize("s", [64, 65])
def test_k3_matches_plain_version_at_the_one_shot_shapes(cuda, name, s):
    starts, m, bands, warpgroups = _k3_oneshot(name, cuda)
    assert warpgroups == {"general": 2, "cubic": 1}[name]
    n_tiles, w_band, tile = m.shape
    x = _data(s, int(starts[-1]) + w_band, cuda, s)
    ref = general.general_resample_reference(x, m, starts, w_band=w_band,
                                             tile=tile, tier="highest")
    for w in (1, 2):
        y = general.general_resample(x, m, starts, w_band=w_band, tile=tile,
                                     bands=bands, warpgroups=w, tier="highest")
        assert y.shape == ref.shape == (s, n_tiles * tile)
        assert (y - ref).abs().max().item() <= TOL


@pytest.mark.cuda
def test_k2_k3_output_bits_do_not_depend_on_the_launch(cuda):
    rt, ipx, wx, p2 = _operator(PLANS[0], False, cuda)
    r = rt.t().contiguous()
    xt = _data(31 * ipx + wx, 6, cuda, 2)
    kw = dict(ipx=ipx, wx=wx, p2=p2, op=banded.prepare(rt, tier="highest"),
              tier="highest")
    whole = tmajor.fused_resample_tmajor(xt, r, n_frames=32, **kw)
    a = tmajor.fused_resample_tmajor(xt[:15 * ipx + wx].contiguous(), r,
                                     n_frames=16, **kw)
    b = tmajor.fused_resample_tmajor(xt[16 * ipx:].contiguous(), r,
                                     n_frames=16, **kw)
    assert torch.equal(whole, torch.cat([a, b]))
    x, m, starts, bands = _k3_case(6, 10, 300, 256, 5000, cuda, 3)
    for w in (1, 2):
        kw = dict(w_band=300, tile=256, warpgroups=w, tier="highest")
        whole = general.general_resample(x, m, starts, bands=bands, **kw)
        parts = [general.general_resample(
            x, m[i:j].contiguous(), starts[i:j],
            bands=bands[i:j].contiguous(), **kw) for i, j in ((0, 4), (4, 10))]
        assert torch.equal(whole, torch.cat(parts, dim=1))
        assert torch.equal(general.general_resample(
            x[:2].contiguous(), m, starts, bands=bands, **kw), whole[:2])
    # At the one-shot shapes, with their block widths, across stream
    # blocks: 65 streams against the first 64 and the last one alone, and
    # a split of tiles.
    for name in ("general", "cubic"):
        starts, m, bands, w = _k3_oneshot(name, cuda)
        n_tiles, w_band, tile = m.shape
        kw = dict(w_band=w_band, tile=tile, bands=bands, warpgroups=w,
                  tier="highest")
        x = _data(65, int(starts[-1]) + w_band, cuda, 4)
        whole = general.general_resample(x, m, starts, **kw)
        assert torch.equal(general.general_resample(
            x[:64].contiguous(), m, starts, **kw), whole[:64])
        assert torch.equal(general.general_resample(
            x[64:].contiguous(), m, starts, **kw), whole[64:])
        h = n_tiles // 3
        kw["bands"] = bands[h:].contiguous()
        assert torch.equal(general.general_resample(
            x, m[h:].contiguous(), starts[h:], **kw), whole[:, h * tile:])


@pytest.mark.cuda
def test_k2_k3_reject_what_they_do_not_take(cuda):
    rt, ipx, wx, p2 = _operator(PLANS[0], False, cuda)
    r = rt.t().contiguous()
    xt = torch.zeros((15 * ipx + wx, 4), device=cuda)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=16, tier="highest")
    x, m, starts, bands = _k3_case(4, 3, 20, 16, 100, cuda, 4)
    gk = dict(w_band=20, tile=16, bands=bands, tier="highest")
    before = (tmajor.launches, general.launches)
    with pytest.raises(TypeError, match="float32"):
        tmajor.fused_resample_tmajor(xt.double(), r.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tmajor.fused_resample_tmajor(
            torch.zeros((xt.shape[0], 8), device=cuda)[:, ::2], r, **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        tmajor.fused_resample_tmajor(xt, r.cpu(), **kw)
    with pytest.raises(ValueError, match="op=banded.prepare"):
        tmajor.fused_resample_tmajor(xt, r, **kw)     # R not prepared
    with pytest.raises(TypeError, match="float32"):
        general.general_resample(x.double(), m.double(), starts, **gk)
    with pytest.raises(ValueError, match="contiguous"):
        general.general_resample(
            torch.zeros((4, 200), device=cuda)[:, ::2], m, starts, **gk)
    with pytest.raises(ValueError, match="one CUDA device"):
        general.general_resample(x, m, starts.cpu(), **gk)
    with pytest.raises(TypeError, match="int32 or int64"):
        general.general_resample(x, m, starts.float(), **gk)
    with pytest.raises(ValueError, match="bands=general.band_table"):
        general.general_resample(x, m, starts, w_band=20, tile=16,
                                 tier="highest")
    with pytest.raises(ValueError, match="bands must be"):
        general.general_resample(x, m, starts, w_band=20, tile=16,
                                 bands=bands.cpu(), tier="highest")
    with pytest.raises(ValueError, match="warpgroups must be 1 or 2"):
        general.general_resample(x, m, starts, w_band=20, tile=16,
                                 bands=bands, warpgroups=4, tier="highest")
    assert (tmajor.launches, general.launches) == before


# -- K1 and K2 at the decimation operator ----------------------------------------

def _decim_operator(device):
    """R_t of 48k -> 16k HIGH as the engines use it at block 2048
    ([2882, 512] over 1536), on ``device``."""
    eng = EngineCore(plan_engine(48000, 16000, Quality.HIGH), block=2048,
                     device="cpu")
    r_t, ipx, wx, p2 = eng._band[:4]
    return r_t.to(device), ipx, wx, p2


@pytest.mark.cuda
@pytest.mark.parametrize("s,nf", [(256, 2), (37, 5), (1, 1)])
def test_k1_k2_match_plain_versions_at_the_decimation_operator(cuda, s, nf):
    rt, ipx, wx, p2 = _decim_operator(cuda)
    op = banded.prepare(rt, tier="highest")
    assert op.split == 8
    x = _data(s, (nf - 1) * ipx + wx + 7, cuda, s)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=nf, tier="highest")
    before = (fused.launches, tmajor.launches)
    y1 = fused.fused_resample(x, rt, op=op, **kw)
    y2 = tmajor.fused_resample_tmajor(x.t().contiguous(), rt.t().contiguous(),
                                      op=op, **kw)
    torch.cuda.synchronize()
    assert (fused.launches, tmajor.launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fused.fused_resample_reference(x, rt, **kw)
    assert y1.shape == ref.shape == (s, nf * p2)
    assert (y1 - ref).abs().max().item() <= TOL
    assert (y2.t() - ref).abs().max().item() <= TOL
    assert torch.equal(y2, y1.t())              # K2 == K1 bit for bit


@pytest.mark.cuda
def test_bits_do_not_depend_on_streams_or_frames_with_the_cluster_split(
        cuda):
    """With the decimation operator's band split across clusters of 8, an
    output's bits do not depend on how many streams or frames a launch
    holds, in K1 or K2."""
    rt, ipx, wx, p2 = _decim_operator(cuda)
    op = banded.prepare(rt, tier="highest")
    x = _data(300, 5 * ipx + wx, cuda, 7)
    kw = dict(ipx=ipx, wx=wx, p2=p2, op=op, tier="highest")
    whole = fused.fused_resample(x, rt, n_frames=6, **kw)
    assert torch.equal(fused.fused_resample(x[:37].contiguous(), rt,
                                            n_frames=6, **kw), whole[:37])
    assert torch.equal(fused.fused_resample(x[:, 2 * ipx:].contiguous(), rt,
                                            n_frames=3, **kw),
                       whole[:, 2 * p2:5 * p2])
    r = rt.t().contiguous()
    xt = x.t().contiguous()
    whole_t = tmajor.fused_resample_tmajor(xt, r, n_frames=6, **kw)
    assert torch.equal(whole_t, whole.reshape(300, 6, p2).permute(
        1, 2, 0).reshape(6 * p2, 300))
    assert torch.equal(tmajor.fused_resample_tmajor(
        xt[:, 5:42].contiguous(), r, n_frames=6, **kw), whole_t[:, 5:42])
    assert torch.equal(tmajor.fused_resample_tmajor(
        xt[ipx:].contiguous(), r, n_frames=5, **kw), whole_t[p2:])


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q", [PLANS[0], (48000, 16000, Quality.HIGH)])
def test_prepare_on_the_card_equals_the_host(cuda, rates_q):
    eng = EngineCore(plan_engine(*rates_q), block=2048, device="cpu")
    r_t = eng._band.r_t
    host = banded.prepare(r_t, tier="highest")
    card = banded.prepare(r_t.to(cuda), tier="highest")
    assert card.packed.device.type == card.bands.device.type == "cuda"
    assert torch.equal(card.packed.cpu(), host.packed)
    assert torch.equal(card.bands.cpu(), host.bands)
    assert (card.split, card.wx, card.p2) == (host.split, host.wx, host.p2)
    dev = EngineCore(plan_engine(*rates_q), block=2048)
    assert torch.equal(dev._band.op.packed.cpu(), host.packed)


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


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q,wrapper", [
    ((44100, 48000, Quality.HIGH), fused),
    ((48000, 16000, Quality.HIGH), fused),
    ((48000, 96000, Quality.HIGH), fused),
    ((44100, 48001, Quality.HIGH), general),
    ((44100, 48000, Quality.QUICK), general),
])
def test_oneshot_apply_prepares_nothing(cuda, monkeypatch, rates_q, wrapper):
    """``_oneshot_aux`` prepares every operator K1 and K3 read (the dft_up
    prestage's band and M's band table included): the apply gives the
    same bits with the preparation disabled."""
    plan = plan_engine(*rates_q)
    x = _data(3, 5000, cuda, 23)
    aux = oneshot._oneshot_aux(plan, 5000, torch.float32, cuda,
                               tier="highest")
    want = oneshot._oneshot_apply(plan, x, aux, tier="highest")

    def no_preparation(*a, **kw):
        raise AssertionError("operator prepared in the apply")

    monkeypatch.setattr(banded, "prepare", no_preparation)
    monkeypatch.setattr(convolve, "band_matrix", no_preparation)
    monkeypatch.setattr(general, "band_table", no_preparation)
    before = wrapper.launches
    assert torch.equal(oneshot._oneshot_apply(plan, x, aux,
                                              tier="highest"), want)
    assert wrapper.launches == before + 1


# -- the precision tiers ('high': three bf16 passes; 'default': one) -------------

TIERS = ("high", "default")


def _rel_err(y, ref):
    """max|y - ref| over max|ref|: the products of a tier are exact in
    both, so only the order of the sums differs (2e-5 of max|y|)."""
    return ((y - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("s,nf,which", [
    (1024, 16, "main"), (5, 13, "main"), (37, 20, "down"), (256, 2, "decim"),
    (37, 5, "decim"), (1, 1, "main"),
])
def test_k1_k2_at_each_tier_match_plain_versions(cuda, tier, s, nf, which):
    """K1 and K2 at a bf16 tier against their plain versions (TF32 off),
    and K2 == K1 bit for bit."""
    if which == "decim":
        rt, ipx, wx, p2 = _decim_operator(cuda)
    else:
        rt, ipx, wx, p2 = _operator(PLANS[1] if which == "down" else PLANS[0],
                                    True, cuda)
    op = banded.prepare(rt, tier)
    assert op.tier == tier
    x = _data(s, (nf - 1) * ipx + wx + 3, cuda, s)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=nf, tier=tier)
    before = (fused.launches, tmajor.launches)
    y1 = fused.fused_resample(x, rt, op=op, **kw)
    y2 = tmajor.fused_resample_tmajor(x.t().contiguous(), rt.t().contiguous(),
                                      op=op, **kw)
    torch.cuda.synchronize()
    assert (fused.launches, tmajor.launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fused.fused_resample_reference(x, rt, **kw)
    assert _rel_err(y1, ref) <= TOL
    assert torch.equal(y2, y1.t())
    exact = fused.fused_resample_reference(x, rt, **dict(kw, tier="highest"))
    assert not torch.equal(ref, exact)            # the tier is applied
    with pytest.raises(ValueError, match="tier"):
        fused.fused_resample(x, rt, op=banded.prepare(rt, "highest"), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("which", ["main", "decim"])
def test_k1_k2_bits_at_each_tier_do_not_depend_on_the_launch(cuda, tier,
                                                            which):
    """65 streams against 64 and 1, and a split of the frames."""
    rt, ipx, wx, p2 = (_decim_operator(cuda) if which == "decim"
                       else _operator(PLANS[0], False, cuda))
    kw = dict(ipx=ipx, wx=wx, p2=p2, op=banded.prepare(rt, tier), tier=tier)
    x = _data(65, 5 * ipx + wx, cuda, 5)
    whole = fused.fused_resample(x, rt, n_frames=6, **kw)
    assert torch.equal(fused.fused_resample(x[:64].contiguous(), rt,
                                            n_frames=6, **kw), whole[:64])
    assert torch.equal(fused.fused_resample(x[64:].contiguous(), rt,
                                            n_frames=6, **kw), whole[64:])
    assert torch.equal(fused.fused_resample(x[:, 2 * ipx:].contiguous(), rt,
                                            n_frames=4, **kw),
                       whole[:, 2 * p2:])
    r, xt = rt.t().contiguous(), x.t().contiguous()
    whole_t = tmajor.fused_resample_tmajor(xt, r, n_frames=6, **kw)
    assert torch.equal(whole_t, whole.reshape(65, 6, p2).permute(
        1, 2, 0).reshape(6 * p2, 65))
    assert torch.equal(tmajor.fused_resample_tmajor(
        xt[:, :64].contiguous(), r, n_frames=6, **kw), whole_t[:, :64])


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("warpgroups", [1, 2])
def test_k3_at_each_tier_matches_plain_version(cuda, tier, warpgroups):
    cases = [_k3_case(65, 7, 17, 200, 500, cuda, 1),
             _k3_case(66, 9, 300, 512, 4000, cuda, 2, (40, 12)),
             _k3_case(9, 4, 37, 30, 601, cuda, 3)]
    for name in ("general", "cubic"):
        starts, m, bands, _ = _k3_oneshot(name, cuda)
        cases.append((_data(65, int(starts[-1]) + m.shape[1], cuda, 6), m,
                      starts, bands))
    for x, m, starts, bands in cases:
        n_tiles, w_band, tile = m.shape
        kw = dict(w_band=w_band, tile=tile, tier=tier)
        ref = general.general_resample_reference(x, m, starts, **kw)
        before = general.launches
        y = general.general_resample(x, m, starts, bands=bands,
                                     warpgroups=warpgroups, **kw)
        torch.cuda.synchronize()
        assert general.launches == before + 1
        assert y.shape == ref.shape and _rel_err(y, ref) <= TOL
        # 65 streams against 64 and 1: the bits do not depend on S.
        assert torch.equal(general.general_resample(
            x[:64].contiguous(), m, starts, bands=bands,
            warpgroups=warpgroups, **kw), y[:64])
        assert torch.equal(general.general_resample(
            x[64:].contiguous(), m, starts, bands=bands,
            warpgroups=warpgroups, **kw), y[64:])


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("rates_q", [PLANS[0], (48000, 16000, Quality.HIGH)])
def test_engines_at_each_tier(cuda, tier, rates_q):
    """Both engines at a tier on the card: TimeMajorEngine == EngineCore
    bit for bit, within the plain version's run (2e-5 of max|y|), and the
    gate: 'xla' and force_xla launch nothing and give the plain version's
    bits on the card."""
    from go_audio_resampler_tpu_torch.ops import precision
    plan = plan_engine(*rates_q)
    kw = dict(batch=5, block=BLOCK, precision=tier)
    core = EngineCore(plan, **kw)
    m = core.device_chunk_multiple
    x = _data(5, 30 * m, cuda, 24)
    before = (fused.launches, tmajor.launches)
    y = torch.cat([core.process_device(x), core.flush_device()], 1)
    tm = TimeMajorEngine(plan, **kw)
    yt = torch.cat([tm.process_device(x.t().contiguous()), tm.flush_device()])
    assert fused.launches > before[0] and tmajor.launches > before[1]
    assert torch.equal(yt.t(), y)
    plain = EngineCore(plan, dispatch="xla", **kw)
    before = (fused.launches, tmajor.launches)
    yp = torch.cat([plain.process_device(x), plain.flush_device()], 1)
    with precision.force_xla():
        forced = EngineCore(plan, **kw)
        yf = torch.cat([forced.process_device(x), forced.flush_device()], 1)
    assert (fused.launches, tmajor.launches) == before
    assert torch.equal(yp, yf)
    assert _rel_err(y, yp) <= TOL
    pallas = EngineCore(plan, dispatch="pallas", **kw)
    assert torch.equal(torch.cat([pallas.process_device(x),
                                  pallas.flush_device()], 1), y)


# -- the general walk, cubic and dft_up ------------------------------------------

WALK = (44100, 48001, Quality.HIGH)


def _walk_state(engine, seed):
    """The walk's polyphase state after a few blocks of noise, and the
    walk's emit arguments."""
    from go_audio_resampler_tpu_torch.engine import stages
    x = np.random.default_rng(seed).normal(
        size=(engine.batch, 3 * engine.block)).astype(np.float32)
    engine.process(x)
    pre, poly = engine.state
    p = engine.plan
    return stages, poly, (p.num_phases, p.poly_taps, p.step_hi, p.step_lo,
                          engine.poly_cap)


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q", [WALK, (48000, 44099, Quality.HIGH),
                                     (44100, 48001, Quality.HIGH, True)])
def test_walk_banded_emit_matches_gather_emit(cuda, monkeypatch, rates_q):
    """On the card the walk emits through the banded tiles; on one block's
    state they agree with the per-output gather within 2e-5, with equal
    counts."""
    plan = plan_engine(*rates_q[:3], hq_interp=len(rates_q) > 3)
    eng = EngineCore(plan, batch=256, block=2048)
    stages, poly, args = _walk_state(eng, 30)
    hist = poly.hist.clone()
    hist[:, poly.hist_len:] = torch.randn(
        (hist.shape[0], hist.shape[1] - poly.hist_len), device=cuda)
    hist_len = poly.hist_len + 2 * 2048
    hist = torch.cat([hist, torch.randn((256, 2 * 2048), device=cuda)], 1)
    call = (eng.banks, hist, hist_len, poly.at_hi, poly.at_lo) + args
    banded_out = stages.poly_emit(*call)
    monkeypatch.setattr(stages, "_banded_emit_on", lambda h: False)
    gather_out = stages.poly_emit(*call)
    assert banded_out[2:] == gather_out[2:] and banded_out[2] > 1000
    assert torch.equal(banded_out[1], gather_out[1])
    assert (banded_out[0] - gather_out[0]).abs().max().item() <= TOL


@pytest.mark.cuda
def test_k1_at_the_walk_prestage_shape(cuda):
    """K1 at the walk's prestage shape (256 streams, T1-1 + 2048 samples,
    period 128, 16 frames) against its plain version."""
    plan = plan_engine(*WALK)
    coeffs = torch.as_tensor(plan.pre_coeffs, dtype=torch.float32,
                             device=cuda)
    n = plan.pre_taps - 1 + 2048
    band = convolve.band_operator(coeffs, n, 1, torch.float32, cuda,
                                  "highest")
    assert band.p == 128 and tuple(band.r_t.shape) == (127 + plan.pre_taps,
                                                        256)
    x = _data(256, n, cuda, 31)
    before = fused.launches
    u = convolve._conv_banded(x, coeffs, 1, interleaved=True, band=band,
                              tier="highest")
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    ref = convolve._conv_frames(x, coeffs, 1, "highest").transpose(
        1, 2).reshape(256, -1)
    assert u.shape == ref.shape == (256, 2 * 2048)
    assert (u - ref).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q", [WALK, (48000, 96000, Quality.HIGH)])
def test_prestage_operator_prepared_once_per_engine(cuda, monkeypatch,
                                                    rates_q):
    """The walk's and dft_up's prestage reads one prepared K1 operator per
    band period, prepared when the engine is built: streaming and
    flushing prepare nothing, and launch K1 once a step."""
    calls = []
    real = banded.prepare

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(banded, "prepare", counted)
    eng = EngineCore(plan_engine(*rates_q), batch=4, block=2048)
    assert len(calls) == 1
    x = np.random.default_rng(32).normal(size=(4, 5 * 2048 + 99)).astype(
        np.float32)
    before = fused.launches
    eng.process(x[:, :3000])
    eng.process(x[:, 3000:])
    eng.flush()
    assert len(calls) == 1
    assert fused.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q", [WALK, (48000, 44099, Quality.HIGH),
                                     (44100, 48000, Quality.QUICK),
                                     (48000, 96000, Quality.HIGH),
                                     (48000, 192000, Quality.MEDIUM)])
def test_walk_cubic_dft_up_engines_match_cpu_float64(cuda, rates_q):
    """The walk (K1 prestage, banded emit), cubic (no kernel) and dft_up
    (K1) on the card within 2e-5 of the float64 CPU engine; K1 launches
    except for cubic, none under force_xla, whose output is the plain
    version's."""
    from go_audio_resampler_tpu_torch.ops import precision
    plan = plan_engine(*rates_q)
    x = np.random.default_rng(33).normal(size=(5, 9000)).astype(np.float32)
    ref = EngineCore(plan, batch=5, block=BLOCK, dtype=torch.float64,
                     device="cpu")
    want = np.concatenate([ref.process(x.astype(np.float64)), ref.flush()],
                          1)
    before = fused.launches
    dev = EngineCore(plan, batch=5, block=BLOCK)
    got = np.concatenate([dev.process(x[:, :4000]), dev.process(x[:, 4000:]),
                          dev.flush()], 1)
    launched = fused.launches - before
    assert (launched > 0) == (plan.kind != "cubic")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    before = fused.launches
    with precision.force_xla():
        plain = EngineCore(plan, batch=5, block=BLOCK)
        yp = np.concatenate([plain.process(x), plain.flush()], 1)
    assert fused.launches == before
    assert np.abs(yp - want).max() <= TOL
    if plan.kind == "dft_up":
        d = EngineCore(plan, batch=5, block=BLOCK)
        yd = torch.cat([d.process_device(torch.from_numpy(x).to(cuda)),
                        d.flush_device()], 1)
        assert yd.shape == want.shape
        assert np.abs(yd.cpu().numpy() - want).max() <= TOL


# -- strict antialias and banded composites ------------------------------------

def _composite(stages):
    """The banded composite of a stage chain, as the JAX package's API
    builds it: ``fuse_chain`` over 48 kHz-based plans, with its stage
    plans' ratio."""
    from go_audio_resampler_tpu_torch.pipeline import BandedPlan, fuse_chain
    plans = [plan_engine(48000, out, Quality.HIGH, strict_antialias=aa)
             for out, aa in stages]
    return BandedPlan(fuse_chain(plans),
                      float(np.prod([p.ratio for p in plans])))


#: 96k -> 44.1k HIGH (a composite with a 294-row head) and 192k -> 48k
#: HIGH (head-free), as the API fuses them.
COMPOSITE_96K = ((24000, False), (44100, True))
COMPOSITE_192K = ((24000, False), (24000, False))
STRICT = (48000, 44100, Quality.HIGH)
STRICT_WALK = (48000, 44099, Quality.HIGH)


def _strict_plan(which):
    if which in (COMPOSITE_96K, COMPOSITE_192K):
        return _composite(which)
    return plan_engine(*which, strict_antialias=True)


@pytest.mark.cuda
def test_k1_at_the_composite_shape(cuda):
    """K1 at the 96k -> 44.1k composite's step (block 2048: R_t [3861, 735]
    over 1600, 256 streams of carry 3690 + block 3200, 2 frames; p2 odd,
    the band split across a cluster) against its plain version."""
    eng = EngineCore(_composite(COMPOSITE_96K), batch=256, block=2048)
    r_t, ipx, wx, p2, carry, op = eng._band
    assert (tuple(r_t.shape), ipx, carry, eng.block) == ((3861, 735), 1600,
                                                         3690, 3200)
    assert op.split > 1
    x = _data(256, carry + eng.block, cuda, 40)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=2, tier="highest")
    before = fused.launches
    y = fused.fused_resample(x, r_t, op=op, **kw)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    ref = fused.fused_resample_reference(x, r_t, **kw)
    assert y.shape == ref.shape == (256, 2 * 735)
    assert (y - ref).abs().max().item() <= TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("which,prepares", [
    (COMPOSITE_96K, 1), (COMPOSITE_192K, 1), (STRICT, 1), (STRICT_WALK, 2)])
def test_strict_and_composite_operators_prepared_once_per_engine(
        cuda, monkeypatch, which, prepares):
    """The composites' and the strict exact plan's fused operator, and the
    walk's prefilter and prestage operators, are prepared when the engine
    is built; streaming and flushing prepare nothing."""
    plan = _strict_plan(which)
    calls = []
    real = banded.prepare

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(banded, "prepare", counted)
    eng = EngineCore(plan, batch=4, block=2048)
    assert len(calls) == prepares
    x = np.random.default_rng(41).normal(size=(4, 5 * 2048 + 99)).astype(
        np.float32)
    before = fused.launches
    eng.process(x[:, :3000])
    eng.process(x[:, 3000:])
    eng.flush()
    assert len(calls) == prepares
    assert fused.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("which", [COMPOSITE_96K, COMPOSITE_192K, STRICT,
                                   STRICT_WALK])
def test_strict_and_composite_engines_match_cpu_float64(cuda, which):
    """Each path on the card within 2e-5 of the float64 CPU engine through
    process(); the static-count ones also through process_device (equal
    to process() bit for bit) and, head-free, TimeMajorEngine (K2)."""
    plan = _strict_plan(which)
    x = np.random.default_rng(42).normal(size=(5, 16000)).astype(np.float32)
    ref = EngineCore(plan, batch=5, block=2048, dtype=torch.float64,
                     device="cpu")
    want = np.concatenate([ref.process(x.astype(np.float64)), ref.flush()],
                          1)
    dev = EngineCore(plan, batch=5, block=2048)
    got = np.concatenate([dev.process(x[:, :4000]), dev.process(x[:, 4000:]),
                          dev.flush()], 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    mult = dev.device_chunk_multiple
    if mult is None:
        return
    n = x.shape[1] // mult * mult
    d = EngineCore(plan, batch=5, block=2048)
    xd = torch.from_numpy(x[:, :n]).to(cuda)
    yd = torch.cat([d.process_device(xd[:, :mult]),
                    d.process_device(xd[:, mult:]), d.flush_device()], 1)
    h = EngineCore(plan, batch=5, block=2048)
    yh = np.concatenate([h.process(x[:, :777]), h.process(x[:, 777:n]),
                         h.flush()], 1)
    assert np.array_equal(yd.cpu().numpy(), yh)
    if plan.kind == "banded" and plan.op.head is not None:
        with pytest.raises(NotImplementedError, match="aperiodic head"):
            TimeMajorEngine(plan, batch=5, block=2048)
        return
    tm = TimeMajorEngine(plan, batch=5, block=2048)
    before = tmajor.launches
    yt = torch.cat([tm.process_device(xd.t().contiguous()),
                    tm.flush_device()], 0)
    assert tmajor.launches > before
    assert yt.shape == (yd.shape[1], 5)
    assert (yt.t() - yd).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q", [STRICT, STRICT_WALK])
def test_strict_oneshot_matches_cpu_float64(cuda, monkeypatch, rates_q):
    """The one-shot of the strict exact plan (K1 with lam) and of the
    walk's (the prefilter on K1, then K3) within 2e-5 of the float64 CPU
    run; ``_oneshot_apply`` prepares nothing."""
    plan = plan_engine(*rates_q, strict_antialias=True)
    x = np.random.default_rng(43).normal(size=(3, 5000)).astype(np.float32)
    want = run_oneshot(plan, x.astype(np.float64), device="cpu").numpy()
    xd = torch.from_numpy(x).to(cuda)
    aux = oneshot._oneshot_aux(plan, 5000, torch.float32, cuda,
                               tier="highest")

    def no_preparation(*a, **kw):
        raise AssertionError("operator prepared in the apply")

    monkeypatch.setattr(banded, "prepare", no_preparation)
    before = (fused.launches, general.launches)
    got = oneshot._oneshot_apply(plan, xd, aux, tier="highest")
    torch.cuda.synchronize()
    assert (fused.launches - before[0], general.launches - before[1]) == (
        (1, 0) if plan.is_rational_exact else (1, 1))
    assert got.shape == want.shape
    assert np.abs(got.cpu().numpy() - want).max() <= TOL


# -- the public API and the FFT routes -------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(44100, 48000), (96000, 44100),
                                   (48000, 16000)])
def test_api_device_mode_matches_cpu_float64(cuda, rates):
    """``Resampler.process_multi_device`` on the card (float32 by
    default) within 2e-5 of max|y| of the float64 CPU run, equal bit for
    bit to ``process_multi`` on the card."""
    import go_audio_resampler_tpu_torch as gar
    r = gar.new_resampler(gar.Config(*rates, channels=2))
    assert r.dtype == np.float32 and r.device.type == "cuda"
    mult = r.device_chunk_multiple
    x = np.random.default_rng(44).normal(size=(2, 6 * mult)) * 0.5
    y = torch.cat([r.process_multi_device(x), r.flush_multi_device()],
                  dim=1)
    assert y.device.type == "cuda" and y.dtype == torch.float32
    r.reset()
    host = np.concatenate([np.stack(r.process_multi(list(x))),
                           np.stack(r.flush_multi())], axis=1)
    assert np.array_equal(y.cpu().numpy(), host)
    ref = gar.new_resampler(gar.Config(*rates, channels=2, device="cpu"))
    want = np.concatenate([np.stack(ref.process_multi(list(x))),
                           np.stack(ref.flush_multi())], axis=1)
    assert want.shape == host.shape
    assert np.abs(host - want).max() <= TOL * np.abs(want).max()


@pytest.mark.cuda
def test_convenience_on_the_card(cuda):
    """The one-shot helpers compute in float32 on the card (K1 or K3) and
    return float64, within 2e-5 of max|y| of the float64 CPU run."""
    import go_audio_resampler_tpu_torch as gar
    x = np.random.default_rng(45).normal(size=4000) * 0.5
    for out in (48000, 48001):
        before = (fused.launches, general.launches)
        got = gar.resample_mono(x, 44100, out)
        assert got.dtype == np.float64
        assert (fused.launches - before[0], general.launches - before[1]) \
            == ((1, 0) if out == 48000 else (0, 1))
        want = gar.resample_mono(x, 44100, out, device="cpu")
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("rates_q", [(96000, 48000, Quality.VERY_HIGH),
                                     (48000, 96000, Quality.HIGH)])
def test_fft_oneshot_matches_k1(cuda, rates_q):
    """``fft_oneshot`` (cuFFT) within 1e-5 of max|y| of ``oneshot`` (K1)."""
    from go_audio_resampler_tpu_torch.engine import fftstage
    plan = plan_engine(*rates_q)
    x = _data(4, 20000, cuda, 46)
    want = run_oneshot(plan, x)
    got = fftstage.fft_oneshot(plan, x)
    assert got.shape == want.shape and got.device.type == "cuda"
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_fft_decimation_device_mode_equals_host(cuda, monkeypatch):
    """The FFT decimation step on the card: ``process_device`` equals
    ``process()`` bit for bit at the same block chunking, and both lie
    within 1e-5 of max|y| of the K1 route."""
    streaming = importlib.import_module(
        "go_audio_resampler_tpu_torch.engine.streaming")
    plan = plan_engine(96000, 48000, Quality.VERY_HIGH)
    k1 = EngineCore(plan, batch=4, block=2048)
    monkeypatch.setattr(streaming, "DECIM_FFT_MIN_TAPS", 0)
    dev, host = (EngineCore(plan, batch=4, block=2048) for _ in range(2))
    assert dev._decim_fft is not None and k1._decim_fft is None
    x = np.random.default_rng(47).normal(size=(4, 20 * dev.block)).astype(
        np.float32)
    blk = dev.block
    y_dev = torch.cat([dev.process_device(x[:, a:a + blk])
                       for a in range(0, x.shape[1], blk)]
                      + [dev.flush_device()], dim=1).cpu().numpy()
    y_host = np.concatenate([host.process(x[:, a:a + blk])
                             for a in range(0, x.shape[1], blk)]
                            + [host.flush()], axis=1)
    assert np.array_equal(y_dev, y_host)
    y_k1 = np.concatenate([k1.process(x), k1.flush()], axis=1)
    assert y_k1.shape == y_host.shape
    assert np.abs(y_host - y_k1).max() <= 1e-5 * np.abs(y_k1).max()


# -- the variable-rate resampler, checkpoints, functional, shims -----------

def _vr_run(vr, x, route, cuts=(3 * 512,)):
    """Feed ``x`` [S, n] through ``process()`` at ``cuts`` or through
    ``process_device`` in block multiples, a slew set after the first
    piece; then flush.  Returns the host array."""
    outs, at = [], 0
    for i, c in enumerate(list(cuts) + [x.shape[1]]):
        piece = x[:, at:c]
        if route == "device":
            outs.append(vr.process_device(
                torch.from_numpy(piece).to(vr.device)).cpu().numpy())
        else:
            outs.append(vr.process(piece))
        at = c
        if i == 0:
            vr.set_io_ratio(48000 / 48010, slew_len=1500)
    tail = vr.flush_device() if route == "device" else vr.flush()
    outs.append(tail.cpu().numpy() if route == "device" else tail)
    return np.concatenate(outs, axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("quality", ["vr", "vr-hq"])
def test_vr_process_device_equals_process_bit_for_bit(cuda, quality):
    from go_audio_resampler_tpu_torch import VariableRateResampler as VR
    x = np.random.default_rng(7).standard_normal((4, 8 * 512)).astype(
        np.float32) * 0.5
    kw = dict(batch=4, block=512, quality=quality, device="cuda")
    before = fused.launches
    host = _vr_run(VR(2.0, 48000 / 47990, **kw), x, "host")
    launched = fused.launches - before
    dev = _vr_run(VR(2.0, 48000 / 47990, **kw), x, "device")
    chunked = _vr_run(VR(2.0, 48000 / 47990, **kw), x, "host",
                      cuts=(3 * 512, 2000, 2901, 3000))
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(chunked, host)
    cpu = _vr_run(VR(2.0, 48000 / 47990, batch=4, block=512,
                     quality=quality, dtype=np.float64, device="cpu"),
                  x.astype(np.float64), "host")
    assert host.shape == cpu.shape
    assert np.abs(host - cpu).max() <= TOL * max(1.0, np.abs(cpu).max())
    # 'vr-hq': one K1 launch (the prestage) a block, the flush's included.
    blocks = x.shape[1] // 512 + 1
    assert launched == (blocks if quality == "vr-hq" else 0)


@pytest.mark.cuda
def test_checkpoint_resumes_bit_identical_on_the_card(cuda, tmp_path):
    from go_audio_resampler_tpu_torch import VariableRateResampler as VR
    from go_audio_resampler_tpu_torch.engine import (load_stream_state,
                                                     load_vr_state,
                                                     save_stream_state,
                                                     save_vr_state)
    plan = plan_engine(44100, 48000, Quality.HIGH)
    x = np.random.default_rng(8).standard_normal((8, 6 * 2352)).astype(
        np.float32)
    full = EngineCore(plan, batch=8, block=2352)
    want = np.concatenate([full.process(x[:, :7000]),
                           full.process(x[:, 7000:]), full.flush()], axis=1)
    a = EngineCore(plan, batch=8, block=2352)
    part = a.process(x[:, :7000])
    save_stream_state(a, tmp_path / "e.npz")
    b = EngineCore(plan, batch=8, block=2352)
    load_stream_state(b, tmp_path / "e.npz")
    assert b.state.device.type == "cuda"
    got = np.concatenate([part, b.process(x[:, 7000:]), b.flush()], axis=1)
    np.testing.assert_array_equal(got, want)
    # The VR mid-slew, resumed from its file.
    kw = dict(batch=8, block=512, quality="vr-hq", device="cuda")
    v_full, v_a, v_b = (VR(2.0, 48000 / 47990, **kw) for _ in range(3))
    for v in (v_full, v_a):
        v.process(x[:, :2000])
        v.set_io_ratio(48000 / 48010, slew_len=3000)
        v.process(x[:, 2000:4000])
    save_vr_state(v_a, tmp_path / "v.npz")
    load_vr_state(v_b, tmp_path / "v.npz")
    want = np.concatenate([v_full.process(x[:, 4000:]), v_full.flush()], 1)
    got = np.concatenate([v_b.process(x[:, 4000:]), v_b.flush()], 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rates,preset", [
    ((48000, 16000), 3), ((44100, 48000), 3), ((48000, 96000), 3),
    ((44100, 48001), 3), ((44100, 48000), 0)])
def test_functional_on_the_card(cuda, rates, preset):
    """The forward launches K1 (once on the exact, decimation and dft_up
    plans, once a block on the walk's block loop, never on cubic's) and
    equals the one-shot; the backward launches nothing and satisfies the
    adjoint identity."""
    from go_audio_resampler_tpu_torch import functional
    quality = functional.QualityPreset(preset)
    plan = functional._plan(float(rates[0]), float(rates[1]), quality)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (8, 2 * rates[0])).astype(np.float32)).to(cuda).requires_grad_()
    before = (fused.launches, general.launches)
    y = functional.resample(x, *rates, quality=quality)
    torch.cuda.synchronize()
    launched = (fused.launches - before[0], general.launches - before[1])
    ref = run_oneshot(plan, x.detach(), device="cuda")
    if functional._needs_length_matrices(plan):
        assert launched[1] == 0
        assert (launched[0] >= 1) == (plan.kind == "two_stage")
        assert (y.detach() - ref).abs().max().item() <= TOL * max(
            1.0, ref.abs().max().item())
    else:
        assert launched == (1, 0)
        assert torch.equal(y.detach(), ref)
    w = torch.randn(y.shape, device=cuda)
    before = (fused.launches, tmajor.launches, general.launches)
    (xbar,) = torch.autograd.grad(y, x, w)
    torch.cuda.synchronize()
    assert (fused.launches, tmajor.launches, general.launches) == before
    lhs = float((y.detach().double() * w.double()).sum())
    rhs = float((x.detach().double() * xbar.double()).sum())
    # float32 products: held to 1e-5 of |y| |w| (the terms' scale)
    scale = float(y.detach().double().norm() * w.double().norm())
    assert abs(lhs - rhs) <= 1e-5 * scale, (lhs, rhs, scale)


@pytest.mark.cuda
def test_shims_equal_the_oneshot_on_the_card(cuda):
    from go_audio_resampler_tpu_torch import soxr_compat, torch_compat
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (4, 9600)).astype(np.float32)).to(cuda)
    plan = plan_engine(96000.0, 44100.0, Quality.HIGH)
    y = torch_compat.Resample(96000, 44100)(x)
    ref = run_oneshot(plan, x, device="cuda")
    assert y.device == x.device and y.dtype == x.dtype
    assert torch.equal(y, ref[:, :y.shape[1]])
    frames = x[:2].T.cpu().numpy()
    ys = soxr_compat.resample(frames, 96000, 44100)
    np.testing.assert_array_equal(ys, run_oneshot(
        plan, x[:2], device="cuda").cpu().numpy().T)


@pytest.mark.cuda
def test_sharded_engine_on_one_card_equals_serial(cuda):
    """World size 1 on ``nccl``: the sharded engine launches what the
    serial one launches on the same rows and gives its bits; the stream
    step's peak is the MAX all-reduce of max|y|."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from go_audio_resampler_tpu_torch import parallel
    mesh = parallel.make_mesh(1)
    try:
        plan = plan_engine(44100, 48000, Quality.HIGH)
        sh = parallel.ShardedEngineCore(plan, mesh, batch_per_device=16,
                                        block=2352)
        ser = EngineCore(plan, batch=16, block=2352)
        x = _data(16, 20 * 2352, cuda, 11)
        before = fused.launches
        ys = [sh.process_device(x[:, a:a + 2352])
              for a in range(0, x.shape[1], 2352)] + [sh.flush_device()]
        launched = fused.launches - before
        yr = [ser.process_device(x[:, a:a + 2352])
              for a in range(0, x.shape[1], 2352)] + [ser.flush_device()]
        assert fused.launches - before == 2 * launched
        assert all(isinstance(y, DTensor) and y.placements == (Shard(0),)
                   for y in ys)
        assert torch.equal(torch.cat([y.to_local() for y in ys], dim=1),
                           torch.cat(yr, dim=1))
        init, step, blk = parallel.sharded_stream_step(plan, mesh, 16, 2352)
        state, y, n, peak = step(init(), x[:, :blk])
        assert float(peak) == float(y.to_local().abs().max())
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cli_on_the_card_equals_engine(cuda, tmp_path):
    """resample_wav on the card (float32, K1 through ``stream()``) writes
    the port's ``EngineCore`` output, read back bit for bit (32f)."""
    from go_audio_resampler_tpu_torch.cli import resample_wav
    from go_audio_resampler_tpu_torch.utils.wav import WavReader, WavWriter
    n = 3 * 65536 + 1234
    x = np.random.default_rng(4).uniform(-0.5, 0.5, (n, 2)).astype(
        np.float32)
    w = WavWriter(tmp_path / "in.wav", 44100, 2, "32f")
    w.write(x)
    w.close()
    before = fused.launches
    assert resample_wav.run([str(tmp_path / "in.wav"),
                             str(tmp_path / "out.wav"), "-bits", "32f"]) == 0
    assert fused.launches > before
    r = WavReader(tmp_path / "out.wav")
    got = r.read(r.num_frames)
    plan = plan_engine(44100, 48000, Quality.HIGH)
    eng = EngineCore(plan, batch=2, block=8192)
    want = np.concatenate(list(eng.stream(
        [x[a:a + 65536].T.copy() for a in range(0, n, 65536)])), axis=1).T
    assert got.shape == (plan.lengths.canonical(n), 2)
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_device_peaks_knows_the_card(cuda):
    from go_audio_resampler_tpu_torch.utils import roofline
    p = roofline.device_peaks()
    assert p["kind"] == torch.cuda.get_device_name(0)
    assert p["bf16_tflops"] > 0 and p["power_limit"]


# -- process() through the engine's pinned buffers -------------------------------

#: The media server's step: 1,344 streams of one 20 ms frame at 44.1 kHz.
SERVE_STREAMS, SERVE_FRAME = 1344, 882


def _frames(s, width, steps, seed):
    return np.random.default_rng(seed).normal(
        size=(s, width * steps)).astype(np.float32)


def _frame(x, i):
    return x[:, i * SERVE_FRAME:(i + 1) * SERVE_FRAME]


@pytest.mark.cuda
def test_process_at_the_serve_shape_equals_process_device(cuda):
    """20 frames and the flush at 1,344 x 882: process(), each frame a whole
    block past the FIFO and through the pinned buffers, gives the bits of
    process_device(); every step is counted as staged, and each returned
    array stays as it was through the later steps."""
    plan = plan_engine(*PLANS[0])
    kw = dict(batch=SERVE_STREAMS, block=SERVE_FRAME)
    host, dev = EngineCore(plan, **kw), EngineCore(plan, **kw)
    assert host.block == SERVE_FRAME and host._stage_in is None
    x = _frames(SERVE_STREAMS, SERVE_FRAME, 20, 40)
    streaming.staged_steps = streaming.fifo_bypass_blocks = 0
    before = fused.launches
    outs = []
    for i in range(20):
        outs.append(host.process(_frame(x, i)))
        if i:
            assert not np.shares_memory(outs[-1], outs[-2])
    kept = [y.copy() for y in outs]
    outs.append(host.flush())
    assert streaming.staged_steps == fused.launches - before > 20
    assert streaming.fifo_bypass_blocks == 20
    assert host._stage_in.is_pinned() and host._stage_out.is_pinned()
    assert all(np.array_equal(y, k) for y, k in zip(outs, kept))
    want = torch.cat([dev.process_device(torch.from_numpy(x).to(cuda)),
                      dev.flush_device()], 1).cpu().numpy()
    assert np.array_equal(np.concatenate(outs, 1), want)


@pytest.mark.cuda
def test_walk_process_past_and_through_the_fifo(cuda):
    """The general walk on the card: whole blocks past the FIFO and chunks
    through it give the same bits over 20 blocks and the flush, each step
    staged."""
    plan = plan_engine(*WALK)
    a, b = EngineCore(plan, batch=256, block=2048), \
        EngineCore(plan, batch=256, block=2048)
    x = _frames(256, a.block, 20, 41)
    streaming.staged_steps = 0
    ya = [a.process(x[:, i * a.block:(i + 1) * a.block]) for i in range(20)]
    kept = [y.copy() for y in ya]
    ya.append(a.flush())
    steps = streaming.staged_steps
    assert steps > 20
    cuts = list(range(0, x.shape[1], 1500)) + [x.shape[1]]
    yb = [b.process(x[:, i:j]) for i, j in zip(cuts, cuts[1:])] + [b.flush()]
    assert streaming.staged_steps > steps
    assert all(np.array_equal(y, k) for y, k in zip(ya, kept))
    assert np.array_equal(np.concatenate(ya, 1), np.concatenate(yb, 1))


@pytest.mark.cuda
def test_set_carry_then_process_at_once(cuda):
    """A carry set and a block processed at once, with nothing between them,
    give the bits of the same with the card synchronised between the two:
    no staging buffer is written while a copy still reads it."""
    plan = plan_engine(*PLANS[0])
    kw = dict(batch=SERVE_STREAMS, block=SERVE_FRAME)
    x = _frames(SERVE_STREAMS, SERVE_FRAME, 4, 42)
    runs = []
    for sync in (False, True):
        eng = EngineCore(plan, **kw)
        carry = np.random.default_rng(43).normal(
            size=tuple(eng.state.shape)).astype(np.float32)
        ys = []
        for i in range(4):
            eng.set_carry(carry * (i + 1))
            if sync:
                torch.cuda.synchronize()
            ys.append(eng.process(_frame(x, i)))
        ys.append(eng.flush())
        runs.append(np.concatenate(ys, 1))
    assert np.array_equal(*runs)
