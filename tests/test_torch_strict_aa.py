"""PyTorch port vs JAX package: the strict-antialias and banded-composite
paths of the engines and the one-shot.

The port runs on ``device='cpu'`` (its kernels' plain versions) against
the JAX package on the CPU, both fed the same numpy inputs and the same
filter banks (plans and operators carried across as arrays): float64 to
1e-12, float32 to 2e-5, with identical output lengths.  The paths:

- A: the banded composite of 96 kHz -> 44.1 kHz HIGH (a 2x decimator,
  then 48k -> 44.1k with the strict-antialias prefilter), which has an
  aperiodic head, through ``EngineCore``;
- B: 48k -> 44.1k HIGH with the prefilter composed into the exact
  operator, through ``EngineCore`` and ``TimeMajorEngine``;
- C: the head-free composite of 192 kHz -> 48 kHz HIGH (two 2x
  decimators) through ``TimeMajorEngine``, held against the JAX
  ``EngineCore`` (the JAX ``TimeMajorEngine`` cannot build it);
- D: 48k -> 44.099k HIGH, the non-exact walk behind the prefilter's FIFO,
  through ``EngineCore.process``;
- E: the one-shot of B and D.

The engines on the card are checked in ``test_torch_cuda.py``.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine import oneshot as joneshot
from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.engine.streaming import EngineCore as JEngine
from go_audio_resampler_tpu.engine.tmajor import TimeMajorEngine as JTMajor
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu.pipeline import fused as jfused
from go_audio_resampler_tpu_torch.engine import (EngineCore, TimeMajorEngine,
                                                 oneshot, plan_from_arrays)
from go_audio_resampler_tpu_torch.ops import convolve
from go_audio_resampler_tpu_torch.ops.precision import default_error_bound
from go_audio_resampler_tpu_torch.pipeline import fused as tfused

toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")
streaming = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.streaming")

TOL = {np.float32: 2e-5, np.float64: 1e-12}
BATCH = 2
HIGH = 3


@functools.lru_cache(maxsize=None)
def _plans(a, b, aa=False, q=HIGH):
    jp = jplan_engine(float(a), float(b), JQuality(q), aa)
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _composite(name):
    """(JAX BandedPlan, port BandedPlan) of a composite, built as the JAX
    package's ``api.Resampler._build_exec`` builds it: ``fuse_chain`` over
    48 kHz-based stage plans, the ratio their product."""
    stages = {"A": [(48000, 24000, False), (48000, 44100, True)],
              "C": [(48000, 24000, False), (48000, 24000, False)],
              "MEDIUM": [(48000, 24000, False, 2), (48000, 44100, True, 2)]
              }[name]
    pairs = [_plans(*s) for s in stages]
    jop = jfused.fuse_chain([j for j, _ in pairs])
    ratio = float(np.prod([j.ratio for j, _ in pairs]))
    latency = sum(j.latency() for j, _ in pairs)
    top = tfused.banded_op_from_arrays(
        {f: getattr(jop, f) for f in ("P", "I", "W", "R", "lam", "lengths",
                                      "head")})
    return (jfused.BandedPlan(jop, ratio, latency=latency),
            tfused.BandedPlan(top, ratio, latency=latency))


PATHS = {"A": lambda: _composite("A"),
         "B": lambda: _plans(48000, 44100, True),
         "C": lambda: _composite("C"),
         "D": lambda: _plans(48000, 44099, True)}


def _engines(path, dtype, block=512, batch=BATCH):
    jp, tp = PATHS[path]()
    return (JEngine(jp, batch=batch, block=block, dtype=dtype),
            EngineCore(tp, batch=batch, block=block, dtype=dtype,
                       device="cpu"))


def _splits(rng, n, max_chunk):
    cuts, at = [], 0
    while at < n:
        step = int(rng.integers(0, max_chunk + 1))
        cuts.append((at, min(n, at + step)))
        at += step
    return cuts


def _close(a, b, dtype):
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL[dtype])


def _host_run(eng, x, cuts):
    return np.concatenate([np.asarray(eng.process(x[:, a:b]))
                           for a, b in cuts] + [np.asarray(eng.flush())], 1)


# -- the operators -------------------------------------------------------------

def test_path_operators_at_full_size():
    """The shapes the API builds at HIGH: A is P=147, I=320, W=2581,
    lam=490 with a [294, 2901] head; B is [147, 841] over I=160, lam=245;
    C is P=1, I=4, W=2701, no head."""
    a = _composite("A")[1].op
    assert (a.P, a.I, a.W, a.lam, a.head.shape) == (147, 320, 2581, 490,
                                                    (294, 2901))
    assert np.count_nonzero(a.R) == 332807
    r, p2, ipx, lam = toneshot._fused_rational_matrix(_plans(48000, 44100,
                                                             True)[1])
    assert (r.shape, ipx, lam) == ((147, 841), 160, 245)
    assert np.count_nonzero(r) == 100327
    c = _composite("C")[1].op
    assert (c.P, c.I, c.W, c.lam, c.head) == (1, 4, 2701, 0, None)


@pytest.mark.parametrize("path,block", [("A", 512), ("A", 2048),
                                        ("B", 512), ("C", 2048),
                                        ("D", 512), ("D", 2048)])
def test_engine_constants_match_jax(path, block):
    """Block, superframe, carry, drop, device granule, flush bound and
    latency; at block 2048 A is R_t [3861, 735] over 1600 (block 3200), C
    [450, 4497] over 1800."""
    je, te = _engines(path, np.float32, block=block)
    assert te.block == je.block
    assert te.device_chunk_multiple == je.device_chunk_multiple
    assert te._flush_limit == je._flush_extra_limit()
    assert te.get_latency() == je.get_latency()
    assert te._drop == (je._drop_override if je._drop_override is not None
                        else je.plan.lengths.drop_prefix())
    if path == "D":
        assert te._has_aa and te._aa_delay == je._aa_delay == 245
        assert te._aa_band is None
        return
    name = {"A": "_banded", "C": "_banded", "B": "_rational"}[path]
    assert te._period == je._device_params()
    assert te._band.carry == getattr(je, name + "_carry")
    assert np.array_equal(te._band.r_t.numpy(),
                          np.asarray(getattr(je, name + "_rt")))
    lam = te.plan.op.lam if path != "B" else 245
    assert te._band.carry % te._band.ipx == lam % te._band.ipx
    if (path, block) == ("A", 2048):
        assert te._band[1:4] == (1600, 3861, 735) and te.block == 3200
        assert te._head_t.shape == (2901, 294)
    if path == "C":
        assert te._band[1:4] == (1800, 4497, 450) and te._head_t is None


# -- EngineCore: process() ------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("path", ["A", "B", "C", "D"])
def test_process_flush_random_chunks(path, dtype):
    je, te = _engines(path, dtype)
    rng = np.random.default_rng(31)
    n = 6000
    x = rng.normal(size=(BATCH, n)).astype(dtype)
    cuts = _splits(rng, n, 2500) + [(n, n)]
    yj, yt = _host_run(je, x, cuts), _host_run(te, x, cuts)
    assert yt.dtype == dtype
    assert yt.shape[1] == te.plan.lengths.canonical(n)
    _close(yt, yj, dtype)
    assert te.get_statistics() == je.get_statistics()


@pytest.mark.parametrize("path", ["A", "D"])
def test_chunking_and_block_invariance(path):
    """Random chunk splits and other blocks give one canonical stream:
    through the aa FIFO's delay bookkeeping (D) and through the head rows
    (A)."""
    x = np.random.default_rng(32).normal(size=(BATCH, 7000))
    _, a = _engines(path, np.float64)
    want = np.concatenate([a.process(x), a.flush()], 1)
    assert want.shape[1] == a.plan.lengths.canonical(7000)
    for seed, block in ((33, 512), (34, 1000), (35, 2048)):
        b = EngineCore(a.plan, batch=BATCH, block=block, dtype=np.float64,
                       device="cpu")
        got = _host_run(b, x, _splits(np.random.default_rng(seed), 7000,
                                      700))
        _close(got, want, np.float64)


@pytest.mark.parametrize("n", [0, 1, 100, 245, 246, 513])
def test_short_inputs_through_the_prefilter(n):
    """Inputs shorter than the prefilter's delay (245) or one block."""
    je, te = _engines("D", np.float64)
    x = np.random.default_rng(n).normal(size=(BATCH, n))
    yj = np.concatenate([np.asarray(je.process(x)), np.asarray(je.flush())],
                        1)
    yt = np.concatenate([te.process(x), te.flush()], 1)
    assert yt.shape[1] == te.plan.lengths.canonical(n)
    _close(yt, yj, np.float64)


def test_head_rows_are_the_composite_rows():
    """The first n_head outputs follow the head rows, not R: the engine's
    stream equals the operator's own apply, and R's periodic rows alone
    differ there."""
    _, te = _engines("A", np.float64)
    op = te.plan.op
    x = np.random.default_rng(36).normal(size=(BATCH, 4000))
    y = np.concatenate([te.process(x), te.flush()], 1)
    want = op.apply(x)
    _close(y, want, np.float64)
    periodic = tfused.BandedOp(**{**op.__dict__, "head": None}).apply(x)
    assert np.abs(periodic[:, :op.n_head] - want[:, :op.n_head]).max() > 1e-6
    _close(periodic[:, op.n_head:], want[:, op.n_head:], np.float64)


# -- EngineCore: the device modes -----------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("path,block", [("A", 512), ("A", 2048),
                                        ("B", 512), ("C", 2048)])
def test_device_mode(path, block, dtype):
    """process_device/flush_device against the JAX engine's, and against
    process()/flush(): at block 512 A's period is 320 samples (147
    outputs), so its first emitting chunks are shorter than the 294-row
    head, which straddles them; at 2048 one period is 1600 samples (735
    outputs)."""
    je, te = _engines(path, dtype, block=block)
    mult = te.device_chunk_multiple
    rng = np.random.default_rng(37)
    widths = [mult] * 9 + [0, 3 * mult, 2 * mult]
    n = sum(widths)
    x = rng.normal(size=(BATCH, n)).astype(dtype)
    outs_j, outs_t, at = [], [], 0
    for w in widths:
        yj = np.asarray(je.process_device(jnp.asarray(x[:, at:at + w])))
        yt = te.process_device(torch.from_numpy(x[:, at:at + w]))
        assert isinstance(yt, torch.Tensor) and yt.shape == yj.shape
        outs_j.append(yj)
        outs_t.append(yt.numpy())
        at += w
    outs_j.append(np.asarray(je.flush_device()))
    outs_t.append(te.flush_device().numpy())
    yj, yt = np.concatenate(outs_j, 1), np.concatenate(outs_t, 1)
    assert yt.shape[1] == te.plan.lengths.canonical(n)
    _close(yt, yj, dtype)
    _, host = _engines(path, dtype, block=block)
    _close(yt, _host_run(host, x, _splits(rng, n, 900)), dtype)


def test_device_mode_head_split_anywhere():
    """The head rows cover a split of the first outputs at any place:
    every split of the head between two process_device chunks gives the
    stream of one chunk."""
    _, te = _engines("A", np.float64)
    mult = te.device_chunk_multiple
    x = np.random.default_rng(38).normal(size=(BATCH, 20 * mult))
    want = torch.cat([te.process_device(torch.from_numpy(x)),
                      te.flush_device()], 1).numpy()
    for k in range(6, 10):
        te.reset()
        got = torch.cat([te.process_device(torch.from_numpy(x[:, :k * mult])),
                         te.process_device(torch.from_numpy(x[:, k * mult:])),
                         te.flush_device()], 1).numpy()
        _close(got, want, np.float64)


def test_stream_with_head():
    je, te = _engines("A", np.float64)
    chunks = [np.random.default_rng(39).normal(size=(BATCH, w))
              for w in (100, 2000, 5, 1500, 333)]
    yj = np.concatenate([np.asarray(y) for y in je.stream(chunks)], 1)
    yt = np.concatenate(list(te.stream(chunks)), 1)
    _close(yt, yj, np.float64)


@pytest.mark.parametrize("path", ["A", "B", "D"])
@pytest.mark.parametrize("tier", ["high", "default"])
def test_reduced_tiers(path, tier):
    """The composite (A), the composed exact operator (B) and the walk
    behind the prefilter (D) at 'high' within 3e-4 of max|y| of JAX's
    float64 run, at 'default' within bf16's roundoff bound of the
    products (``precision.default_error_bound``); 'highest' is closer."""
    x = np.random.default_rng(40).normal(size=(BATCH, 4000)).astype(
        np.float32)
    je, te = _engines(path, np.float64)
    want = _host_run(je, x.astype(np.float64), [(0, 4000)])
    runs = {}
    for t in (tier, "highest"):
        e = EngineCore(te.plan, batch=BATCH, block=512, dtype=np.float32,
                       device="cpu", precision=t)
        runs[t] = _host_run(e, x, [(0, 1234), (1234, 4000)])
        assert runs[t].shape == want.shape
    err = np.abs(runs[tier] - want).max()
    x_max = float(np.abs(x).max())
    if tier == "high":
        bound = 3e-4 * np.abs(want).max()
    elif path == "D":
        p = te.plan
        aa = np.asarray(p.aa_coeffs)[:, None]
        pre = np.asarray(p.pre_coeffs).T
        rows = sum(np.abs(np.asarray(b)) for b in (
            p.bank_a, p.bank_b, p.bank_c, p.bank_d)).T
        l1 = [float(np.abs(a).sum(axis=0).max()) for a in (aa, pre, rows)]
        # the prefilter's error through the walk, the walk's own on the
        # prefiltered signal (|u| <= max|x| * L1(aa))
        bound = (default_error_bound(x_max, aa) * l1[1] * l1[2]
                 + default_error_bound(x_max * l1[0], pre) * l1[2]
                 + default_error_bound(x_max * l1[0] * l1[1], rows))
    else:
        bound = default_error_bound(x_max, te._band.r_t)
    assert err <= bound, (err, bound)
    assert np.abs(runs["highest"] - want).max() < err


# -- TimeMajorEngine -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("path", ["B", "C"])
def test_tmajor(path, dtype):
    """The head-free composite (C), held against the JAX ``EngineCore``,
    and the composed exact operator (B), against both JAX engines."""
    je, te = _engines(path, dtype, block=2048)
    jp, tp = PATHS[path]()
    tm = TimeMajorEngine(tp, batch=BATCH, block=2048, dtype=dtype,
                         device="cpu")
    assert tm.chunk_multiple == te.device_chunk_multiple
    mult = tm.chunk_multiple
    x = np.random.default_rng(41).normal(size=(BATCH, 7 * mult)).astype(
        dtype)
    cuts = [(0, mult), (mult, 4 * mult), (4 * mult, 7 * mult)]
    yt = torch.cat([tm.process_device(torch.from_numpy(x[:, a:b].T.copy()))
                    for a, b in cuts] + [tm.flush_device()], 0).numpy().T
    yj = np.concatenate(
        [np.asarray(je.process_device(jnp.asarray(x[:, a:b])))
         for a, b in cuts] + [np.asarray(je.flush_device())], 1)
    assert yt.shape[1] == tp.lengths.canonical(7 * mult)
    _close(yt, yj, dtype)
    if path == "B":
        jt = JTMajor(jp, batch=BATCH, block=2048, dtype=dtype)
        yjt = np.concatenate(
            [np.asarray(jt.process_device(jnp.asarray(x[:, a:b].T)))
             for a, b in cuts] + [np.asarray(jt.flush_device())], 0).T
        _close(yt, yjt, dtype)


def test_tmajor_head_free_composite_jax_fails():
    """The JAX ``TimeMajorEngine`` promises head-free composites but reads
    the absent head's shape; the port runs them (a deliberate
    departure)."""
    jp, tp = _composite("C")
    with pytest.raises(AttributeError):
        JTMajor(jp, batch=BATCH)
    assert TimeMajorEngine(tp, batch=BATCH, device="cpu").chunk_multiple


def test_tmajor_composite_with_head_raises():
    jp, tp = _composite("A")
    with pytest.raises(NotImplementedError) as want:
        JTMajor(jp, batch=BATCH)
    with pytest.raises(NotImplementedError) as got:
        TimeMajorEngine(tp, batch=BATCH, device="cpu")
    assert str(got.value) == str(want.value)


# -- one-shot ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("path", ["B", "D"])
@pytest.mark.parametrize("n", [1, 300, 5000])
def test_oneshot(path, n, dtype):
    jp, tp = PATHS[path]()
    x = np.random.default_rng(n).normal(size=(BATCH, n)).astype(dtype)
    want = np.asarray(joneshot(jp, x, dtype=dtype))
    got = oneshot(tp, x, device="cpu").numpy()
    assert got.dtype == dtype and got.shape[1] == tp.lengths.canonical(n)
    _close(got, want, dtype)


@pytest.mark.parametrize("path", ["B", "D"])
def test_oneshot_equals_the_stream(path):
    x = np.random.default_rng(42).normal(size=(BATCH, 5000))
    _, te = _engines(path, np.float64)
    y = _host_run(te, x, _splits(np.random.default_rng(43), 5000, 1500))
    _close(oneshot(te.plan, x, device="cpu").numpy(), y, np.float64)


@pytest.mark.parametrize("path", ["B", "D"])
def test_oneshot_aux_prepares_the_prefilter(path, monkeypatch):
    """``_oneshot_aux`` carries B's ``lam`` and D's prefilter taps (the
    banded convolution's operator, None on the CPU); the apply builds no
    operator (``band_operator`` unused)."""
    _, tp = PATHS[path]()
    aux = toneshot._oneshot_aux(tp, 3000, torch.float64, "cpu",
                                tier="highest")
    if path == "B":
        assert len(aux) == 4 and aux[3] == 245
    else:
        assert len(aux) == 6 and aux[5] is None
        assert np.array_equal(aux[4].numpy()[0], tp.aa_coeffs)

    def no(*a, **k):
        raise AssertionError("the apply built an operator")

    monkeypatch.setattr(convolve, "band_operator", no)
    x = torch.from_numpy(np.random.default_rng(44).normal(size=(2, 3000)))
    y = toneshot._oneshot_apply(tp, x, aux, tier="highest")
    assert y.shape == (2, tp.lengths.canonical(3000))


# -- the FFT prefilter route ------------------------------------------------

def test_fft_prefilter_raises(monkeypatch):
    """A prefilter of FFT_CONV_MIN_TAPS taps or more runs through FFT
    overlap-save in the walk and the one-shot, as in the JAX package: with
    both packages' crossover lowered to D's taps, both agree with the JAX
    package's FFT route to 1e-11 (the FFT routes' float64 tolerance); an
    exact plan (B) composes any prefilter into its operator."""
    assert toneshot.FFT_CONV_MIN_TAPS == joneshot.__globals__[
        "FFT_CONV_MIN_TAPS"] == 6144
    jp, tp = PATHS["D"]()
    jmod = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
    monkeypatch.setattr(toneshot, "FFT_CONV_MIN_TAPS", tp.aa_taps)
    monkeypatch.setattr(streaming, "FFT_CONV_MIN_TAPS", tp.aa_taps)
    monkeypatch.setattr(jmod, "FFT_CONV_MIN_TAPS", tp.aa_taps)
    jmod._oneshot_jit.clear_cache()
    x = np.random.default_rng(45).normal(size=(BATCH, 3000))
    try:
        je, te = _engines("D", np.float64)
        assert te._aa_spec is not None
        cuts = _splits(np.random.default_rng(46), 3000, 1000)
        got, want = _host_run(te, x, cuts), _host_run(je, x, cuts)
        got1 = oneshot(tp, x, device="cpu").numpy()
        want1 = np.asarray(joneshot(jp, x, dtype=np.float64))
    finally:
        jmod._oneshot_jit.clear_cache()
    for a, b in ((got, want), (got1, want1)):
        assert a.shape == b.shape == (BATCH, tp.lengths.canonical(3000))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-11)
    _, tb = PATHS["B"]()
    assert EngineCore(tb, device="cpu")._band is not None
    assert oneshot(tb, np.zeros((1, 1000)), device="cpu").shape[1] > 0
