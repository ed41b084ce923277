"""PyTorch port vs JAX package: the stage functions of the streaming engine.

Each stage of the port's ``engine/stages.py`` runs on CPU tensors against
its namesake in the JAX package's ``engine/stages.py`` on the CPU, on the
same numpy-seeded inputs: the walks' integers equal, outputs to 1e-12 in
float64 and 2e-5 in float32, and the stage states equal after several
steps.  The polyphase emit is checked in both lowerings: the per-output
gather (the CPU's) and the banded tiles (float32 on the card's), each
against the JAX package's function of the same lowering.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine import stages as jst
from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu_torch.engine import stages as tst

TOL = {np.float32: 2e-5, np.float64: 1e-12}
I31 = 2 ** 31 - 1


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


def _tdt(dtype):
    return torch.float32 if dtype == np.float32 else torch.float64


def _ints_equal(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


# -- the walks -----------------------------------------------------------------

def _last16(at_lo, q, s_lo, count):
    """at_hi at which walk16's last integer part is 2^31 - 1, the JAX
    package's int32 bound."""
    return I31 - (count - 1) * q - ((at_lo + (count - 1) * s_lo) >> 16)


@pytest.mark.parametrize("at_hi,at_lo,q,s_lo,count", [
    (67_030, 0, 373, 310, 2231),                # 44.1k -> 48.001k HIGH
    (37, 1234, 282, 65511, 512),                # 48k -> 44.099k HIGH
    (0, 65535, 0, 65535, 32767),                # cap 32767, largest limb
    (_last16(65535, 2, 65535, 32767), 65535, 2, 65535, 32767),
    (_last16(7, 65535, 0, 32767), 7, 65535, 0, 32767),
])
def test_walk16_integers_equal(at_hi, at_lo, q, s_lo, count):
    hi_j, frac_j = jst.walk16(jnp.int32(at_hi), jnp.int32(at_lo), q, s_lo,
                              count)
    hi_t, frac_t = tst.walk16(at_hi, at_lo, q, s_lo, count)
    _ints_equal(hi_t, hi_j)
    _ints_equal(frac_t, frac_j)
    for n in (0, 1, count // 3, count - 1):
        want = jst._advance16(jnp.int32(at_hi), jnp.int32(at_lo), q, s_lo,
                              jnp.int32(n))
        assert tst._advance16(at_hi, at_lo, q, s_lo, n) == tuple(
            int(w) for w in want)
    if count == 32767 and q:
        assert int(hi_t[-1]) == I31


def _last32(f1, f0, q, s1, s0, count):
    """at_int at which walk32's last integer part is 2^31 - 1."""
    n = count - 1
    return I31 - n * q - ((f1 + n * s1 + ((f0 + n * s0) >> 16)) >> 16)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("at,step,count", [
    ((0, 0, 0), 3946001203, 2078),              # 44.1k -> 48k QUICK
    ((5, 40000, 123), 4674794336, 1755),        # 48k -> 44.1k QUICK
    ((0, 65535, 65535), 65535 * 65536 + 65535, 32767),
    ((_last32(65535, 65535, 1, 65535, 65535, 32767), 65535, 65535),
     (1 << 32) + 65535 * 65536 + 65535, 32767),
])
def test_walk32_integers_and_fraction_equal(at, step, count, dtype):
    q, s1, s0 = step >> 32, (step >> 16) & 0xFFFF, step & 0xFFFF
    i_j, x_j = jst.walk32(*(jnp.int32(a) for a in at), q, s1, s0, count,
                          dtype=dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    i_t, x_t = tst.walk32(*at, q, s1, s0, count, dtype=tdt)
    _ints_equal(i_t, i_j)
    assert x_t.dtype == tdt
    assert np.array_equal(x_t.numpy(), np.asarray(x_j))   # bit for bit
    for n in (0, 1, count - 1):
        want = jst._advance32(*(jnp.int32(a) for a in at), q, s1, s0,
                              jnp.int32(n))
        assert tst._advance32(*at, q, s1, s0, n) == tuple(int(w)
                                                          for w in want)


def test_count_below_is_the_walks_valid_count():
    rng = np.random.default_rng(0)
    for _ in range(50):
        at_hi, at_lo = int(rng.integers(0, 5000)), int(rng.integers(0, 65536))
        q, s_lo = int(rng.integers(0, 400)), int(rng.integers(0, 65536))
        count, limit = int(rng.integers(0, 3000)), int(rng.integers(0, 10 ** 6))
        hi, _ = tst.walk16(at_hi, at_lo, q, s_lo, count)
        assert tst._count_below(
            lambda j: tst._walk16_at(j, at_hi, at_lo, q, s_lo)[0], count,
            limit) == int((hi < limit).sum())


# -- the polyphase emit ----------------------------------------------------------

#: Plans of the emit: non-exact up and down, the deepest fractional down
#: (largest step), a near-unity walk, and the hq_interp banks.
EMIT_PLANS = [(44100, 48001, {}), (48000, 44099, {}), (96000, 44100, {}),
              (44100, 44101, {}), (44100, 48001, {"hq_interp": True})]


def _emit_case(rates, dtype, cap=512, hw=4096, seed=3):
    plan = jplan_engine(float(rates[0]), float(rates[1]), JQuality.HIGH,
                        **rates[2])
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(3, hw)).astype(dtype)
    banks = [np.asarray(b, dtype) for b in
             (plan.bank_a, plan.bank_b, plan.bank_c, plan.bank_d)]
    args = (plan.num_phases, plan.poly_taps, plan.step_hi, plan.step_lo, cap)
    return plan, hist, banks, args


def _jax_emit(hist, banks, hist_len, at_hi, at_lo, args):
    return jst.poly_emit(tuple(jnp.asarray(b) for b in banks),
                         jnp.asarray(hist), jnp.int32(hist_len),
                         jnp.int32(at_hi), jnp.int32(at_lo), *args)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates", EMIT_PLANS)
@pytest.mark.parametrize("hist_len,at_hi,at_lo", [
    (4032, 37, 1234),           # a full cap inside the history
    (700, 8_000, 99),           # the history runs out: a partial emit
])
def test_poly_emit_gather_matches_jax(rates, dtype, hist_len, at_hi, at_lo):
    _, hist, banks, args = _emit_case(rates, dtype)
    y_j, v_j, n_j, hi_j, lo_j = _jax_emit(hist, banks, hist_len, at_hi,
                                          at_lo, args)
    y_t, v_t, n_t, hi_t, lo_t = tst.poly_emit(
        tuple(torch.from_numpy(b) for b in banks), torch.from_numpy(hist),
        hist_len, at_hi, at_lo, *args)
    assert (n_t, hi_t, lo_t) == (int(n_j), int(hi_j), int(lo_j))
    assert np.array_equal(v_t.numpy(), np.asarray(v_j))
    assert 0 < n_t <= args[-1]
    _close(y_t, y_j, dtype)


def _banded_args(plan, hi, frac, dtype, cap):
    """div, phase, x edge-padded to whole tiles, and the static span, as
    the JAX package's poly_emit forms them."""
    L, taps, q = plan.num_phases, plan.poly_taps, plan.step_hi
    tv = jst.POLY_EMIT_TILE if cap >= jst.POLY_EMIT_TILE else 128
    pad = -cap % tv
    div = hi // L
    phase = hi - div * L
    x = frac.astype(dtype) * (1.0 / 65536.0)
    div_adv = ((tv - 1) * (q + 1)) // L + 1
    span = -(-(div_adv + taps) // 128) * 128
    return [np.pad(a, (0, pad), mode='edge') for a in (div, phase, x)], \
        span, tv


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates", EMIT_PLANS)
@pytest.mark.parametrize("cap", [512, 300, 128])
def test_banded_emit_matches_jax(rates, dtype, cap):
    """The banded-tile lowering, the port's against the JAX package's
    ``_poly_emit_banded`` on the same padded walk."""
    plan, hist, banks, args = _emit_case(rates, dtype, cap=cap)
    hi, frac = (np.asarray(a) for a in jst.walk16(
        jnp.int32(37), jnp.int32(1234), plan.step_hi, plan.step_lo, cap))
    (div, phase, x), span, tv = _banded_args(plan, hi, frac, dtype, cap)
    y_j = jst._poly_emit_banded(
        tuple(jnp.asarray(b) for b in banks), jnp.asarray(hist),
        jnp.asarray(div), jnp.asarray(phase), jnp.asarray(x),
        plan.poly_taps, span, tv)
    y_t = tst._poly_emit_banded(
        tuple(torch.from_numpy(b) for b in banks), torch.from_numpy(hist),
        torch.from_numpy(div), torch.from_numpy(phase), torch.from_numpy(x),
        plan.poly_taps, span, tv)
    _close(y_t, y_j, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates", EMIT_PLANS)
def test_poly_emit_banded_lowering_matches_jax_gather(monkeypatch, rates,
                                                      dtype):
    """``poly_emit`` with the card's lowering chosen (the banded tiles, its
    edge padding and span) against the JAX package's gather emit: the
    lowerings differ only in the order of the sums."""
    _, hist, banks, args = _emit_case(rates, dtype, cap=2231)
    monkeypatch.setattr(tst, "_banded_emit_on", lambda h: True)
    y_j, v_j, n_j, hi_j, lo_j = _jax_emit(hist, banks, 4000, 37, 1234, args)
    y_t, v_t, n_t, hi_t, lo_t = tst.poly_emit(
        tuple(torch.from_numpy(b) for b in banks), torch.from_numpy(hist),
        4000, 37, 1234, *args)
    assert (n_t, hi_t, lo_t) == (int(n_j), int(hi_j), int(lo_j))
    assert np.array_equal(v_t.numpy(), np.asarray(v_j))
    _close(y_t, y_j, dtype)


def test_banded_block_places_each_coefficient_once():
    """The one-hot block ``b`` of the banded emit, built by one scatter,
    equals the JAX package's sum of ``taps`` one-hot selects bit for bit."""
    plan, hist, banks, _ = _emit_case(EMIT_PLANS[0], np.float32, cap=512)
    hi, frac = (np.asarray(a) for a in jst.walk16(
        jnp.int32(37), jnp.int32(1234), plan.step_hi, plan.step_lo, 512))
    (div, phase, x), span, tv = _banded_args(plan, hi, frac, np.float32, 512)
    n_t, taps = 512 // tv, plan.poly_taps
    k = tst.poly_coeff_matrix(tuple(torch.from_numpy(b) for b in banks),
                              torch.from_numpy(phase),
                              torch.from_numpy(x)).reshape(n_t, tv, taps)
    rel = torch.from_numpy(div).reshape(n_t, tv)
    rel = rel - rel[:, :1]
    b = torch.zeros((n_t, tv, span))
    b.scatter_(2, rel[..., None] + torch.arange(taps), k)
    want = torch.zeros((n_t, tv, span))
    shifted = torch.arange(span)[None, None, :] - rel[..., None]
    for j in range(taps):
        want = want + torch.where(shifted == j, k[:, :, j, None], 0.0)
    assert torch.equal(b, want)
    assert int((b != 0).sum(dim=2).max()) <= taps


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_poly_coeff_matrix_matches_jax(dtype):
    plan, _, banks, _ = _emit_case(EMIT_PLANS[0], dtype)
    rng = np.random.default_rng(4)
    phase = rng.integers(0, plan.num_phases, size=300)
    x = rng.random(300).astype(dtype)
    want = jst.poly_coeff_matrix(tuple(jnp.asarray(b) for b in banks),
                                 jnp.asarray(phase), jnp.asarray(x))
    got = tst.poly_coeff_matrix(tuple(torch.from_numpy(b) for b in banks),
                                torch.from_numpy(phase), torch.from_numpy(x))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates", EMIT_PLANS[:2])
def test_poly_process_steps_match_jax(rates, dtype):
    """Several steps of the polyphase stage from its engine's initial
    state: outputs, counts and every field of the state equal."""
    plan, _, banks, _ = _emit_case(rates, dtype)
    m, cap = 1024, 600
    step_in = -(-plan.step // (plan.num_phases * 65536))
    size = plan.poly_taps + step_in + 2 + m + plan.lengths.core_delta()
    at0 = plan.at0
    js = jst.PolyState(hist=jnp.zeros((3, size), dtype),
                       hist_len=jnp.int32(0), at_hi=jnp.int32(at0 >> 16),
                       at_lo=jnp.int32(at0 & 0xFFFF))
    ts = tst.PolyState(hist=torch.zeros((3, size), dtype=_tdt(dtype)),
                       hist_len=0, at_hi=at0 >> 16, at_lo=at0 & 0xFFFF)
    rng = np.random.default_rng(5)
    args = (plan.num_phases, plan.poly_taps, plan.step_hi, plan.step_lo,
            cap)
    total = 0
    for _ in range(6):
        u = rng.normal(size=(3, m)).astype(dtype)
        js, y_j, v_j, n_j = jst.poly_process(
            tuple(jnp.asarray(b) for b in banks), js, jnp.asarray(u), *args)
        ts, y_t, v_t, n_t = tst.poly_process(
            tuple(torch.from_numpy(b) for b in banks), ts,
            torch.from_numpy(u), *args)
        assert n_t == int(n_j) and np.array_equal(v_t.numpy(),
                                                  np.asarray(v_j))
        _close(y_t, y_j, dtype)
        assert (ts.hist_len, ts.at_hi, ts.at_lo) == (
            int(js.hist_len), int(js.at_hi), int(js.at_lo))
        assert np.array_equal(ts.hist.numpy(), np.asarray(js.hist))
        total += n_t
    assert total > 0


def test_poly_process_refuses_to_overflow_the_history():
    plan, _, banks, _ = _emit_case(EMIT_PLANS[0], np.float64)
    st = tst.PolyState(hist=torch.zeros((1, 100), dtype=torch.float64),
                       hist_len=60, at_hi=0, at_lo=0)
    with pytest.raises(ValueError, match="exceed the history"):
        tst.poly_process(tuple(torch.from_numpy(b) for b in banks), st,
                         torch.zeros((1, 41), dtype=torch.float64),
                         plan.num_phases, plan.poly_taps, plan.step_hi,
                         plan.step_lo, 64)


# -- prestage, FIR, decimation, cubic and linear -------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates_q", [(44100, 48001, 3), (48000, 192000, 2)])
def test_prestage_process_steps_match_jax(rates_q, dtype):
    plan = jplan_engine(rates_q[0], rates_q[1], JQuality(rates_q[2]))
    coeffs = np.asarray(plan.pre_coeffs, dtype)
    rng = np.random.default_rng(6)
    js = jst.PrestageState(carry=jnp.zeros((2, plan.pre_taps - 1), dtype))
    ts = tst.PrestageState(carry=torch.zeros((2, plan.pre_taps - 1),
                                             dtype=_tdt(dtype)))
    for b in (300, 300, 77):
        x = rng.normal(size=(2, b)).astype(dtype)
        js, u_j = jst.prestage_process(jnp.asarray(coeffs), js,
                                       jnp.asarray(x), plan.factor)
        ts, u_t = tst.prestage_process(torch.from_numpy(coeffs), ts,
                                       torch.from_numpy(x), plan.factor)
        assert u_t.shape == (2, plan.factor * b)
        _close(u_t, u_j, dtype)
        assert np.array_equal(ts.carry.numpy(), np.asarray(js.carry))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fir_process_steps_match_jax(dtype):
    rng = np.random.default_rng(7)
    coeffs = rng.normal(size=91).astype(dtype)
    cj = jnp.zeros((2, 90), dtype)
    ct = torch.zeros((2, 90), dtype=_tdt(dtype))
    for b in (200, 64, 500):
        x = rng.normal(size=(2, b)).astype(dtype)
        cj, y_j = jst.fir_process(jnp.asarray(coeffs), cj, jnp.asarray(x))
        ct, y_t = tst.fir_process(torch.from_numpy(coeffs), ct,
                                  torch.from_numpy(x))
        _close(y_t, y_j, dtype)
        assert np.array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("factor,taps", [(3, 61), (2, 40), (4, 9)])
def test_decim_process_steps_match_jax(factor, taps, dtype):
    rng = np.random.default_rng(8 + factor)
    coeffs = rng.normal(size=taps).astype(dtype)
    js = jst.DecimState(carry=jnp.zeros((2, taps - 1), dtype),
                        next_rel=jnp.int32(taps - 1))
    ts = tst.DecimState(carry=torch.zeros((2, taps - 1), dtype=_tdt(dtype)),
                        next_rel=taps - 1)
    for b in (128, 7, 128, 7):
        x = rng.normal(size=(2, b)).astype(dtype)
        js, y_j, v_j, n_j = jst.decim_process(jnp.asarray(coeffs), js,
                                              jnp.asarray(x), factor)
        ts, y_t, v_t, n_t = tst.decim_process(torch.from_numpy(coeffs), ts,
                                              torch.from_numpy(x), factor)
        assert n_t == int(n_j) == int(v_t.sum())
        assert np.array_equal(v_t.numpy(), np.asarray(v_j))
        _close(y_t, y_j, dtype)
        assert ts.next_rel == int(js.next_rel)
        assert np.array_equal(ts.carry.numpy(), np.asarray(js.carry))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("which", ["cubic", "linear"])
@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 44100),
                                   (8000, 44100)])
def test_interp_process_steps_match_jax(rates, which, dtype):
    plan = jplan_engine(rates[0], rates[1], JQuality.QUICK)
    assert plan.kind == 'cubic'
    step, block = plan.cubic_step, 256
    cap = -(-(block << 32) // step) + 1
    jfn = jst.cubic_process if which == "cubic" else jst.linear_process
    tfn = tst.cubic_process if which == "cubic" else tst.linear_process
    js = jst.CubicState(carry=jnp.zeros((2, 3), dtype), at_int=jnp.int32(0),
                        at_f1=jnp.int32(0), at_f0=jnp.int32(0))
    ts = tst.CubicState(carry=torch.zeros((2, 3), dtype=_tdt(dtype)),
                        at_int=0, at_f1=0, at_f0=0)
    rng = np.random.default_rng(9)
    for _ in range(5):
        x = rng.normal(size=(2, block)).astype(dtype)
        js, y_j, v_j, n_j = jfn(js, jnp.asarray(x), step, cap)
        ts, y_t, v_t, n_t = tfn(ts, torch.from_numpy(x), step, cap)
        assert n_t == int(n_j)
        assert np.array_equal(v_t.numpy(), np.asarray(v_j))
        _close(y_t, y_j, dtype)
        assert (ts.at_int, ts.at_f1, ts.at_f0) == (
            int(js.at_int), int(js.at_f1), int(js.at_f0))
        assert np.array_equal(ts.carry.numpy(), np.asarray(js.carry))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_hermite4_and_linear2_match_jax(dtype):
    rng = np.random.default_rng(10)
    w = rng.normal(size=(3, 50, 4)).astype(dtype)
    x = rng.random(50).astype(dtype)
    _close(tst.hermite4(torch.from_numpy(w), torch.from_numpy(x)),
           jst.hermite4(jnp.asarray(w), jnp.asarray(x)), dtype)
    _close(tst.linear2(torch.from_numpy(w[..., :2]), torch.from_numpy(x)),
           jst.linear2(jnp.asarray(w[..., :2]), jnp.asarray(x)), dtype)
