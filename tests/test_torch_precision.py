"""PyTorch port vs JAX package: the matmul precision tiers and the
dispatch gate (``ops/precision.py``, the counterpart of the JAX package's
``pallas_fused.py:60-148`` and ``:558-611``).

On the CPU the kernels' plain versions form each tier's products as the
CUDA kernels do: ``'high'`` three products of bf16 limbs, ``'default'``
one of bf16-rounded operands, float32 accumulation.  They are held
against the JAX package's Pallas kernels in interpret mode: at ``'high'``
the JAX kernels run the same limb split (``mxu_dot``); at ``'default'``
they run at ``'highest'`` on operands rounded to bf16 beforehand, since
JAX on the CPU computes ``Precision.DEFAULT`` exactly, and exact products
of bf16 values are what the TPU's one pass computes.  Kernel tolerance:
2e-5 of max|y| (the products agree exactly, the sums' order differs).
The engines at each tier are held against the JAX float64 run: 3e-4 of
max|y| at ``'high'`` (``test_precision_tier.py``'s bound), and at
``'default'`` a bound derived from bf16's 2^-9 roundoff
(``precision.default_error_bound``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.engine.streaming import EngineCore as JEngine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu.ops import pallas_fused as pf
import go_audio_resampler_tpu_torch as gart
from go_audio_resampler_tpu_torch import TimeMajorEngine
from go_audio_resampler_tpu_torch.engine import EngineCore, plan_from_arrays
from go_audio_resampler_tpu_torch.ops import (banded, convolve, fused, general,
                                              precision, tmajor)
from go_audio_resampler_tpu_torch.utils import metrics, signals

joneshot = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")

ENV = "GAR_TPU_MATMUL_PRECISION"
KERNEL_TOL = 2e-5          # of max|y|: kernel vs kernel, summation order
HIGH_TOL = 3e-4            # of max|y|: the bf16x3 tier vs float64
THD_FLOOR = {"high": -110.0, "default": -65.0}
BF16_TIERS = ("high", "default")
CD_DAT = (44100, 48000, 3)


def _plans(rates_q):
    jp = jplan_engine(rates_q[0], rates_q[1], JQuality(rates_q[2]))
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 ``a`` rounded to bf16 by JAX, as float32."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _operator(rates_q=CD_DAT):
    """(R_t float32 [wx, p2], ipx, wx, p2) of a plan's fused operator."""
    _, tp = _plans(rates_q)
    r, p2, ipx, _ = toneshot._fused_rational_matrix(tp)
    return (np.ascontiguousarray(r.T).astype(np.float32), ipx, r.shape[1],
            r.shape[0])


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


# -- the tier map ----------------------------------------------------------------

def test_modes_match_the_jax_package():
    assert precision.PRECISION_MODES == pf.PRECISION_MODES
    assert precision.DISPATCH_MODES == pf.DISPATCH_MODES
    assert set(precision.TIERS) == set(pf._PRECISION_TIERS)


def test_default_is_highest(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert precision.dot_precision() == "highest"
    assert precision.dot_precision("auto") == "highest"
    assert pf.dot_precision() == lax.Precision.HIGHEST


@pytest.mark.parametrize("name,want", [("default", "default"),
                                       ("high", "high"),
                                       ("highest", "highest"),
                                       ("HIGH", "high"),
                                       ("Default", "default")])
def test_env_selects_tier(monkeypatch, name, want):
    monkeypatch.setenv(ENV, name)
    assert precision.dot_precision() == want
    assert precision.dot_precision(None) == want
    assert pf.dot_precision() == pf._PRECISION_TIERS[want]
    # An explicit tier overrides the variable.
    assert precision.dot_precision("highest") == "highest"
    assert precision.dot_precision("DEFAULT") == "default"


def test_unknown_tier_raises(monkeypatch):
    monkeypatch.setenv(ENV, "bf16")
    with pytest.raises(KeyError):
        precision.dot_precision()
    with pytest.raises(KeyError):
        pf.dot_precision()
    monkeypatch.delenv(ENV)
    with pytest.raises(KeyError):
        precision.dot_precision("fast")


# -- the limbs and the tiered product ---------------------------------------------

def _limb_inputs():
    rng = np.random.default_rng(7)
    a = (rng.normal(size=(64, 96)) * np.exp(rng.uniform(-20, 20, (64, 96)))
         ).astype(np.float32)
    # Ties: 1 + 2^-8 and 1 + 3 * 2^-8 lie half-way between bf16 values
    # (to even: down and up), and their negatives; zero and a subnormal.
    a.flat[:6] = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                           0x00000000, 0x00000003],
                          dtype=np.uint32).view(np.float32)
    return a


def test_split_bf16_is_bit_equal_to_jax():
    a = _limb_inputs()
    hi, lo = precision.split_bf16(torch.from_numpy(a))
    hi_j = _bf16(a)
    lo_j = _bf16(a - hi_j)
    assert np.array_equal(hi.numpy().view(np.uint32), hi_j.view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), lo_j.view(np.uint32))
    assert hi.numpy().flat[0] == 1.0 and hi.numpy().flat[1] == 1.015625
    with pytest.raises(TypeError, match="float32"):
        precision.bf16_round(torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("tier", BF16_TIERS)
def test_prepared_limbs_are_bit_equal_to_jax(tier):
    """``banded.prepare`` at a bf16 tier packs R's bf16 limbs, bit-equal to
    JAX's rounding, as [column block, k-step, limb * column, tap]."""
    rt, ipx, wx, p2 = _operator()
    op = banded.prepare(torch.from_numpy(rt), tier)
    n_limbs = 2 if tier == "high" else 1
    nb, ks = -(-p2 // 8), -(-wx // 8)
    assert op.tier == tier and op.packed.dtype == torch.bfloat16
    assert tuple(op.packed.shape) == (nb, ks, 8 * n_limbs, 8)
    got = (op.packed.float().view(nb, ks, n_limbs, 8, 8)
           .permute(2, 1, 4, 0, 3).reshape(n_limbs, ks * 8, nb * 8))
    hi_j = _bf16(rt)
    want = [hi_j, _bf16(rt - hi_j)][:n_limbs]
    for limb in range(n_limbs):
        assert np.array_equal(got[limb, :wx, :p2].numpy().view(np.uint32),
                              want[limb].view(np.uint32))
        assert not got[limb, wx:].any() and not got[limb, :, p2:].any()
    ref = banded.prepare(torch.from_numpy(rt), "highest")
    assert torch.equal(op.bands, ref.bands) and op.split == ref.split


def test_prepare_reads_the_tier_and_resolve_checks_it(monkeypatch):
    """``prepare`` takes a resolved tier and never the process-wide one:
    the entry points resolve 'auto'."""
    rt = torch.from_numpy(_operator()[0])
    monkeypatch.setenv(ENV, "high")
    op = banded.prepare(rt, "default")
    assert op.tier == "default"
    assert banded.resolve(op, rt, "k", "default") is op
    with pytest.raises(ValueError, match="tier 'default'"):
        banded.resolve(op, rt, "k", "high")
    assert banded.prepare(rt, "highest").tier == "highest"
    for unresolved in ("auto", None, "High"):
        with pytest.raises(ValueError, match="resolves 'auto'"):
            banded.prepare(rt, unresolved)
    with pytest.raises(TypeError):
        banded.prepare(rt)


def test_tiered_matmul_high_matches_mxu_dot(monkeypatch):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(64, 96)).astype(np.float32)
    b = rng.normal(size=(96, 32)).astype(np.float32)
    want = np.asarray(pf.mxu_dot(jnp.asarray(a), jnp.asarray(b), "high"))
    got = precision.tiered_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                  "high")
    assert _rel(got.numpy(), want) <= KERNEL_TOL
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert 1e-9 < _rel(got.numpy(), exact) < 3e-5
    # Below the entry points the tier is resolved: the process-wide
    # variable is not read, and 'auto' is refused.
    monkeypatch.setenv(ENV, "default")
    assert torch.equal(precision.tiered_matmul(torch.from_numpy(a),
                                               torch.from_numpy(b), "high"),
                       got)
    with pytest.raises(ValueError, match="resolves 'auto'"):
        precision.tiered_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                "auto")


def test_tiered_matmul_default_and_highest():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(40, 70)).astype(np.float32)
    b = rng.normal(size=(70, 24)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    one_pass = np.asarray(jnp.dot(jnp.asarray(_bf16(a)),
                                  jnp.asarray(_bf16(b)),
                                  precision=lax.Precision.HIGHEST))
    got = precision.tiered_matmul(ta, tb, "default")
    assert _rel(got.numpy(), one_pass) <= KERNEL_TOL
    assert _rel(got.numpy(), a.astype(np.float64) @ b) > 1e-4
    assert torch.equal(precision.tiered_matmul(ta, tb, "highest"), ta @ tb)
    # float64 is exact at every tier.
    for tier in precision.TIERS:
        assert torch.equal(precision.tiered_matmul(ta.double(), tb.double(),
                                                   tier),
                           ta.double() @ tb.double())


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "frames"])
def test_highest_plain_versions_are_the_untiered_products(name):
    """At 'highest' each plain version is its one float32 product, the
    same call as before the tiers existed, so its bits are unchanged by
    construction: ``tiered_matmul`` returns ``product(a, b)`` there."""
    rng = np.random.default_rng(13)
    rt, ipx, wx, p2 = _operator()
    r_t = torch.from_numpy(rt)
    if name in ("K1", "K2"):
        x = torch.from_numpy(rng.normal(size=(3, 4 * ipx + wx))
                             .astype(np.float32))
        frames = x[:, :3 * ipx + wx].unfold(1, wx, ipx)
        want = torch.matmul(frames, r_t).reshape(3, -1)
        if name == "K1":
            got = fused.fused_resample_reference(
                x, r_t, ipx=ipx, wx=wx, p2=p2, n_frames=4, tier="highest")
        else:
            xt, r = x.t().contiguous(), r_t.t().contiguous()
            got = tmajor.fused_resample_tmajor_reference(
                xt, r, ipx=ipx, wx=wx, p2=p2, n_frames=4, tier="highest")
            want = torch.matmul(r, xt[:3 * ipx + wx].unfold(0, wx, ipx)
                                .transpose(1, 2)).reshape(4 * p2, 3)
    elif name == "K3":
        x = torch.from_numpy(rng.normal(size=(3, 90)).astype(np.float32))
        m = torch.from_numpy(rng.normal(size=(2, 20, 8)).astype(np.float32))
        starts = torch.tensor([3, 40])
        got = general.general_resample_reference(x, m, starts, w_band=20,
                                                 tile=8, tier="highest")
        windows = torch.stack([x[:, 3:23], x[:, 40:60]], dim=1)
        want = torch.einsum("stw,twp->stp", windows, m).reshape(3, 16)
    else:
        x = torch.from_numpy(rng.normal(size=(3, 90)).astype(np.float32))
        k = torch.from_numpy(rng.normal(size=(2, 9)).astype(np.float32))
        got = convolve.conv1d_poly(x, k, 2, precision="highest")
        want = torch.einsum("sct,ft->sfc", x.unfold(1, 9, 2), k)
    assert torch.equal(got, want)


# -- each kernel's plain version against the JAX kernel ------------------------

def _kernel_operands(tier, *arrays):
    """The JAX kernel's operands and tier for the port's ``tier``: as they
    are at 'high'; rounded to bf16 and run at 'highest' for 'default'."""
    if tier == "default":
        return [_bf16(a) for a in arrays], "highest"
    return list(arrays), tier


@pytest.mark.parametrize("tier", BF16_TIERS)
def test_k1_plain_matches_pallas_interpret(tier):
    rt, ipx, wx, p2 = _operator()
    tf = pf.frame_tile_for(p2)
    nf = 2 * tf
    n = nf * ipx + (wx - ipx)
    x = np.random.default_rng(2).normal(size=(8, n)).astype(np.float32)
    (xj, rj), jtier = _kernel_operands(tier, x, rt)
    y_j = np.asarray(pf.fused_resample_pallas(
        jnp.asarray(xj), jnp.asarray(rj), ipx=ipx, wx=wx, p2=p2, ts=8,
        interpret=True, precision=jtier))
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=nf, tier=tier)
    y_t = fused.fused_resample(torch.from_numpy(x), torch.from_numpy(rt),
                               **kw).numpy()
    assert y_t.shape == y_j.shape == (8, nf * p2)
    assert _rel(y_t, y_j) <= KERNEL_TOL
    assert np.array_equal(y_t, fused.fused_resample_reference(
        torch.from_numpy(x), torch.from_numpy(rt), **kw).numpy())


@pytest.mark.parametrize("tier", BF16_TIERS)
def test_k2_plain_matches_pallas_interpret(tier):
    rt, ipx, wx, p2 = _operator()
    r = np.ascontiguousarray(rt.T)
    nf = 5
    xt = np.random.default_rng(3).normal(
        size=((nf - 1) * ipx + wx, 128)).astype(np.float32)
    (xj, rj), jtier = _kernel_operands(tier, xt, r)
    y_j = np.asarray(pf.fused_resample_tmajor(
        jnp.asarray(xj), jnp.asarray(rj), ipx=ipx, wx=wx, p2=p2, ts=128,
        interpret=True, precision=jtier))
    y_t = tmajor.fused_resample_tmajor(
        torch.from_numpy(xt), torch.from_numpy(r), ipx=ipx, wx=wx, p2=p2,
        n_frames=nf, tier=tier).numpy()
    assert y_t.shape == y_j.shape == (nf * p2, 128)
    assert _rel(y_t, y_j) <= KERNEL_TOL


@pytest.mark.parametrize("tier", BF16_TIERS)
def test_k3_plain_matches_pallas_interpret(monkeypatch, tier):
    """K3's JAX kernel reads the process-wide tier at trace time: set it,
    and clear the kernel's jit cache around the call."""
    rng = np.random.default_rng(4)
    n_tiles, tile, w_band = 4, 256, 300
    w_pad = -(-w_band // 128) * 128
    starts = np.sort(rng.integers(0, 500, size=n_tiles)).astype(np.int32)
    m_t = np.zeros((n_tiles, w_pad, tile), dtype=np.float32)
    m_t[:, :w_band] = rng.normal(size=(n_tiles, w_band, tile)) / 17.0
    fetch = (-(-(w_pad + 128) // 128) * 128) + 128
    x = rng.normal(size=(8, int(starts[-1]) + fetch)).astype(np.float32)
    (xj, mj), jtier = _kernel_operands(tier, x, m_t)
    monkeypatch.setenv(ENV, jtier)
    pf.general_resample_pallas.clear_cache()
    try:
        y_j = np.asarray(pf.general_resample_pallas(
            jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(starts),
            w_band=w_band, tile=tile, ts=8, interpret=True))
    finally:
        pf.general_resample_pallas.clear_cache()
    monkeypatch.delenv(ENV)
    y_t = general.general_resample(
        torch.from_numpy(x), torch.from_numpy(m_t), torch.from_numpy(starts),
        w_band=w_band, tile=tile, tier=tier).numpy()
    assert y_t.shape == y_j.shape == (8, n_tiles * tile)
    assert _rel(y_t, y_j) <= KERNEL_TOL


def test_wrappers_on_the_cpu_count_no_launch():
    rt, ipx, wx, p2 = _operator()
    x = torch.zeros((2, 3 * ipx + wx))
    before = (fused.launches, tmajor.launches, general.launches)
    for tier in precision.TIERS:
        fused.fused_resample(x, torch.from_numpy(rt), ipx=ipx, wx=wx, p2=p2,
                             n_frames=4, tier=tier)
        tmajor.fused_resample_tmajor(x.t().contiguous(),
                                     torch.from_numpy(rt.T.copy()), ipx=ipx,
                                     wx=wx, p2=p2, n_frames=4, tier=tier)
        general.general_resample(x, torch.zeros((2, 20, 8)),
                                 torch.tensor([0, 4]), w_band=20, tile=8,
                                 tier=tier)
    assert (fused.launches, tmajor.launches, general.launches) == before
    for bad in ("bf16", "auto"):
        with pytest.raises(ValueError, match="tier must be one of"):
            fused.fused_resample(x, torch.from_numpy(rt), ipx=ipx, wx=wx,
                                 p2=p2, n_frames=4, tier=bad)


# -- the engines at each tier ----------------------------------------------------

def _run_core(eng, x, rng=None):
    """process() over random chunks (or whole blocks), then flush()."""
    if rng is None:
        cuts = [(a, a + eng.block) for a in range(0, x.shape[1], eng.block)]
    else:
        cuts, at = [], 0
        while at < x.shape[1]:
            step = int(rng.integers(1, 3 * eng.block))
            cuts.append((at, at + step))
            at += step
    return np.concatenate([eng.process(x[:, a:b]) for a, b in cuts]
                          + [eng.flush()], axis=1)


def _run_tmajor(eng, x, rng=None):
    """process_device() over [n, S] chunks of random whole periods (or
    one chunk), then flush_device()."""
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    m = eng.chunk_multiple
    n = xt.shape[0] // m * m
    cuts, at = [], 0
    while at < n:
        step = m * (int(rng.integers(1, 8)) if rng is not None else n // m)
        cuts.append((at, min(n, at + step)))
        at += step
    outs = [eng.process_device(xt[a:b]) for a, b in cuts]
    return torch.cat(outs + [eng.flush_device()]).t().numpy()


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("rates_q", [CD_DAT, (48000, 16000, 3)])
def test_engines_at_each_tier_match_jax_float64(rates_q, tier):
    jp, tp = _plans(rates_q)
    rng = np.random.default_rng(8)
    m = EngineCore(tp, batch=3, block=512, device="cpu").device_chunk_multiple
    n = 40 * m
    x = (0.5 * rng.normal(size=(3, n))).astype(np.float32)
    je = JEngine(jp, batch=3, block=512, dtype=np.float64)
    want = np.concatenate([np.asarray(je.process(x.astype(np.float64))),
                           np.asarray(je.flush())], axis=1)
    core = EngineCore(tp, batch=3, block=512, dtype=torch.float32,
                      precision=tier, device="cpu")
    assert core.precision == tier and core._tier == tier
    got = _run_core(core, x, rng)
    assert got.dtype == np.float32 and got.shape == want.shape == (
        3, tp.lengths.canonical(n))
    core.reset()
    assert np.array_equal(_run_core(core, x), got)    # chunking invariance
    tm = TimeMajorEngine(tp, batch=3, block=512, dtype=torch.float32,
                         precision=tier, device="cpu")
    got_t = _run_tmajor(tm, x, rng)
    tm.reset()
    assert np.array_equal(_run_tmajor(tm, x), got_t)
    assert got_t.shape == want.shape
    if tier == "high":
        bound = HIGH_TOL * np.abs(want).max()
    else:
        bound = precision.default_error_bound(np.abs(x).max(),
                                              core._band.r_t)
    err = max(np.abs(got - want).max(), np.abs(got_t - want).max())
    assert err <= bound, (err, bound)
    # The tier changes the numbers: not the float32-accurate run.
    exact = _run_core(EngineCore(tp, batch=3, block=512, device="cpu",
                                 dtype=torch.float32), x)
    assert np.abs(exact - want).max() < min(err, 2e-5)


@pytest.mark.parametrize("tier", BF16_TIERS)
def test_engine_thd_at_each_tier(tier):
    """The tiers' quality pins (``tools/quality_tpu.py``: 1 kHz sine,
    44.1k -> 48k HIGH, 16384-point THD) on both engines."""
    _, tp = _plans(CD_DAT)
    x = signals.sine(65536, 1000.0, 44100).astype(np.float32)[None]
    core = EngineCore(tp, batch=1, block=2352, precision=tier, device="cpu")
    tm = TimeMajorEngine(tp, batch=1, block=2352, precision=tier,
                         device="cpu")
    for y in (_run_core(core, x), _run_tmajor(tm, x)):
        thd = metrics.thd(y[0].astype(np.float64), 48000, 1000.0, 16384)
        assert thd <= THD_FLOOR[tier], thd


@pytest.mark.parametrize("rates_q", [CD_DAT, (48000, 16000, 3)])
def test_float64_is_exact_at_every_tier(monkeypatch, rates_q):
    _, tp = _plans(rates_q)
    x = np.random.default_rng(9).normal(size=(2, 5000))
    outs = []
    for tier in precision.TIERS:
        eng = EngineCore(tp, batch=2, block=512, dtype=torch.float64,
                         precision=tier, device="cpu")
        outs.append(_run_core(eng, x))
        monkeypatch.setenv(ENV, tier)
        outs.append(gart.oneshot(tp, x, device="cpu").numpy())
        monkeypatch.delenv(ENV)
    for a, b in zip(outs[2::2], outs[3::2]):
        assert np.array_equal(a, outs[0]) and np.array_equal(b, outs[1])


def test_engine_auto_reads_the_tier_when_built(monkeypatch):
    _, tp = _plans(CD_DAT)
    monkeypatch.setenv(ENV, "default")
    eng = EngineCore(tp, batch=1, device="cpu")
    tm = TimeMajorEngine(tp, batch=1, device="cpu")
    monkeypatch.setenv(ENV, "highest")
    assert (eng.precision, eng._tier, tm._tier) == ("auto", "default",
                                                    "default")
    pinned = EngineCore(tp, batch=1, device="cpu", precision="high")
    assert pinned._tier == "high"
    monkeypatch.setenv(ENV, "bf16")
    with pytest.raises(KeyError):
        EngineCore(tp, batch=1, device="cpu")


# -- the gate ----------------------------------------------------------------------

def test_gate_is_open_at_every_tier():
    for tier in (None, "auto") + precision.TIERS:
        assert precision.dispatch_allowed(tier)
        assert precision.dispatch_for("auto", tier)
        assert precision.dispatch_for("pallas", tier)
        assert not precision.dispatch_for("xla", tier)
    with pytest.raises(ValueError, match="dispatch"):
        precision.dispatch_for("tune")
    with pytest.raises(KeyError):
        precision.dispatch_allowed("fast")


def test_force_xla_is_reentrant():
    assert precision._FORCE_XLA_DEPTH == 0
    with precision.force_xla() as outer:
        assert isinstance(outer, precision.force_xla)
        assert not precision.dispatch_for("pallas")
        with precision.force_xla():
            assert precision._FORCE_XLA_DEPTH == 2
            assert not precision.dispatch_allowed("high")
        assert precision._FORCE_XLA_DEPTH == 1
        assert not precision.dispatch_for("auto", "default")
    assert precision.dispatch_for("pallas")
    with pytest.raises(RuntimeError):
        with precision.force_xla():
            raise RuntimeError("inside")
    assert precision._FORCE_XLA_DEPTH == 0


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(kw.get("tier"))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("tier", precision.TIERS)
def test_dispatch_routes_each_step(monkeypatch, tier):
    """'auto' and 'pallas' call the kernel's wrapper (which takes the
    plain version for CPU tensors), 'xla' and force_xla the plain version
    directly; the output is the same, bit for bit."""
    _, tp = _plans(CD_DAT)
    x = np.random.default_rng(10).normal(size=(2, 3000)).astype(np.float32)
    k1 = _spy(monkeypatch, fused, "fused_resample")
    k2 = _spy(monkeypatch, tmajor, "fused_resample_tmajor")
    outs = {}
    for mode in precision.DISPATCH_MODES + ("forced",):
        k1.clear(), k2.clear()
        kw = dict(batch=2, block=588, precision=tier, device="cpu",
                  dispatch="auto" if mode == "forced" else mode)
        core, tm = EngineCore(tp, **kw), TimeMajorEngine(tp, **kw)
        if mode == "forced":
            with precision.force_xla():
                outs[mode] = (_run_core(core, x), _run_tmajor(tm, x))
        else:
            outs[mode] = (_run_core(core, x), _run_tmajor(tm, x))
        through = mode in ("auto", "pallas")
        assert (len(k1) > 0, len(k2) > 0) == (through, through), mode
        assert set(k1 + k2) <= {tier}
    for mode in outs:
        for a, b in zip(outs[mode], outs["auto"]):
            assert np.array_equal(a, b), mode


def test_tune_resolves_off_the_card():
    """'tune' resolves to 'auto' on the CPU in both engines (the JAX
    engine's off the TPU) and streams the 'auto' engine's bits."""
    _, tp = _plans(CD_DAT)
    x = np.random.default_rng(5).normal(size=(2, 3000)).astype(np.float32)
    for cls in (EngineCore, TimeMajorEngine):
        tuned = cls(tp, batch=2, device="cpu", dispatch="tune")
        assert tuned.dispatch == "auto"
        want = cls(tp, batch=2, device="cpu")
        if cls is EngineCore:
            assert tuned.tune_record["pin"] == "auto"
            got = np.concatenate([tuned.process(x), tuned.flush()], axis=1)
            want = np.concatenate([want.process(x), want.flush()], axis=1)
        else:
            n = x.shape[1] // tuned.chunk_multiple * tuned.chunk_multiple
            xt = torch.from_numpy(np.ascontiguousarray(x[:, :n].T))
            got = torch.cat([tuned.process_device(xt),
                             tuned.flush_device()]).numpy()
            want = torch.cat([want.process_device(xt),
                              want.flush_device()]).numpy()
        assert got.shape == want.shape and got.shape[0] > 0
        assert np.array_equal(got, want)


# -- one-shot and the convolution ------------------------------------------------

@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("name,rates_q", [
    ("rational", (44100, 48000, 3)), ("decimate", (48000, 16000, 3)),
    ("dft_up", (48000, 96000, 3)), ("general", (44100, 48001, 3)),
    ("cubic", (44100, 48000, 0))])
def test_oneshot_honours_the_process_wide_tier(monkeypatch, name, rates_q,
                                               tier):
    jp, tp = _plans(rates_q)
    x = (0.5 * np.random.default_rng(11).normal(size=(2, 3000))).astype(
        np.float32)
    want = np.asarray(joneshot.oneshot(jp, jnp.asarray(x, jnp.float64)))
    exact = gart.oneshot(tp, x, device="cpu").numpy()
    k1 = _spy(monkeypatch, fused, "fused_resample")
    k3 = _spy(monkeypatch, general, "general_resample")
    conv = _spy(monkeypatch, convolve, "_conv_frames")
    monkeypatch.setenv(ENV, tier)
    got = gart.oneshot(tp, x, device="cpu").numpy()
    assert got.shape == want.shape == (2, tp.lengths.canonical(3000))
    assert set(k1 + k3) == {tier} or (name == "dft_up" and conv)
    err = np.abs(got - want).max()
    assert np.abs(exact - want).max() < min(err, 2e-5)
    if tier == "high":
        assert err <= HIGH_TOL * np.abs(want).max(), err
    else:                 # a few times bf16's 2^-8 product error
        assert err <= 0.01 * np.abs(want).max(), err


def test_oneshot_aux_prepares_at_the_call_tier(monkeypatch):
    """``oneshot`` reads the process-wide tier once per call and hands it
    to ``_oneshot_aux``, whose K1 operator carries it: a switch of the
    tier between calls prepares new limbs (prepared here on the CPU, as on
    the card)."""
    monkeypatch.setattr(banded, "prepare_on_card", banded.prepare)
    _, tp = _plans(CD_DAT)
    real, seen = toneshot._oneshot_aux, []

    def aux_spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out[2].tier)
        return out

    monkeypatch.setattr(toneshot, "_oneshot_aux", aux_spy)
    x = np.zeros((1, 2000), np.float32)
    for tier in ("high", "default", "highest"):
        monkeypatch.setenv(ENV, tier)
        gart.oneshot(tp, x, device="cpu")
        assert seen[-1] == tier
        assert real(tp, 2000, torch.float32, "cpu", "high")[2].tier == "high"
    with pytest.raises(ValueError, match="resolves 'auto'"):
        real(tp, 2000, torch.float32, "cpu", "auto")


@pytest.mark.parametrize("tier", BF16_TIERS)
def test_conv_banded_and_frames_agree_at_each_tier(tier):
    """The banded lowering (K1's plain version on the CPU) and the frames
    lowering form the same products at a tier."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 900)).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(2, 33)) / 33).astype(np.float32))
    a = convolve._conv_banded(x, k, 1, interleaved=True, tier=tier)
    b = convolve.conv1d_poly_interleaved(x, k, precision=tier)
    assert a.shape == b.shape
    assert _rel(a.numpy(), b.numpy().astype(np.float64)) <= KERNEL_TOL
    with precision.force_xla():
        assert torch.equal(convolve._conv_banded(x, k, 1, interleaved=True,
                                                 tier=tier), a)
