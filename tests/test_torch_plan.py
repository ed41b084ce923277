"""PyTorch port vs JAX package: plans, length models and banded operators.

Every host array the port builds must equal the reference's bit for bit.
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest

from go_audio_resampler_tpu.engine import plan as jplan
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu_torch.engine import plan as tplan
from go_audio_resampler_tpu_torch.filterdesign import Quality as TQuality

# Both packages' engine/__init__ re-export the function oneshot under the
# module's name.
joneshot = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")

RATES = [(44100, 48000), (48000, 44100), (48000, 96000)]
EXACT_RATES = RATES[:2]
QUALITIES = [q.value for q in JQuality]
EXACT_QUALITIES = [q for q in QUALITIES if q != JQuality.QUICK]
COUNTS = [0, 1, 100, 147, 160, 1000, 4410, 44100, 441000]


def _plans(rates, q, **kw):
    return (jplan.plan_engine(*rates, JQuality(q), **kw),
            tplan.plan_engine(*rates, TQuality(q), **kw))


def _assert_same_value(name, a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    elif dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    else:
        assert a == b, name


def _assert_same_plan(jp, tp):
    names = [f.name for f in dataclasses.fields(jp)]
    assert names == [f.name for f in dataclasses.fields(tp)]
    for name in names:
        _assert_same_value(name, getattr(jp, name), getattr(tp, name))
    for prop in ('at0', 'step_hi', 'step_lo', 'is_rational_exact',
                 'fingerprint'):
        assert getattr(jp, prop) == getattr(tp, prop), prop
    assert jp.latency() == tp.latency()
    assert jp.filter_length() == tp.filter_length()
    assert jp.estimate_output(12345) == tp.estimate_output(12345)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("rates", RATES)
def test_plan_fields_equal(rates, q):
    _assert_same_plan(*_plans(rates, q))


@pytest.mark.parametrize("rates,kw", [
    ((48000, 16000), {}),
    ((96000, 48000), {}),
    ((44100, 48001), {}),
    ((48000, 44100), {'strict_antialias': True}),
])
def test_plan_fields_equal_other_topologies(rates, kw):
    jp, tp = _plans(rates, JQuality.HIGH, **kw)
    _assert_same_plan(jp, tp)
    assert jp.algorithm() == tp.algorithm()


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("rates", RATES)
def test_length_model_counts_equal(rates, q):
    jl, tl = (p.lengths for p in _plans(rates, q))
    assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    assert jl.core_delta() == tl.core_delta()
    assert jl.drop_prefix() == tl.drop_prefix()
    for n in COUNTS:
        assert jl.canonical(n) == tl.canonical(n), n
        assert jl.core_emitted(n) == tl.core_emitted(n), n
        assert jl.flush_pad(n) == tl.flush_pad(n), n


@pytest.mark.parametrize("q", [1, 3, 4])
@pytest.mark.parametrize("rates", [(48000, 16000), (96000, 48000),
                                   (48000, 8000)])
def test_decimation_length_model_counts_equal(rates, q):
    """The port counts the decimation stage's outputs in closed form; the
    JAX package walks them one by one.  Both give the same counts."""
    jl, tl = (p.lengths for p in _plans(rates, q))
    assert tl.kind == "decimate"
    for n in COUNTS + [2 * tl.taps - 1, 96000, 480768]:
        assert jl.canonical(n) == tl.canonical(n), n
        assert jl.flush_pad(n) == tl.flush_pad(n), n


@pytest.mark.parametrize("factor,taps", [(2, 163), (3, 1349), (6, 489),
                                         (3, 1), (4, 2)])
def test_decimation_sim_chunked_counts_equal(factor, taps):
    """Chunk by chunk, the phase carry included, the closed-form count
    equals the reference loop's."""
    from go_audio_resampler_tpu.engine.counts import DecimationSim as JSim
    from go_audio_resampler_tpu_torch.engine.counts import (
        DecimationSim as TSim)
    rng = np.random.default_rng(factor * 10000 + taps)
    js, ts = JSim(factor, taps), TSim(factor, taps)
    for n in rng.integers(0, 3 * taps + 7, size=200):
        assert ts.process(int(n)) == js.process(int(n))
        assert (ts.hist, ts.phase) == (js.hist, js.phase)
    assert ts.flush() == js.flush()


@pytest.mark.parametrize("q", EXACT_QUALITIES)
@pytest.mark.parametrize("rates", EXACT_RATES)
def test_fused_rational_matrix_equal(rates, q):
    jp, tp = _plans(rates, q)
    assert jp.is_rational_exact and tp.is_rational_exact
    jr, jp2, jipx, jlam = joneshot._fused_rational_matrix(jp)
    tr, tp2, tipx, tlam = toneshot._fused_rational_matrix(tp)
    assert (jp2, jipx, jlam) == (tp2, tipx, tlam)
    assert jr.dtype == tr.dtype and np.array_equal(jr, tr)
    for block in (512, 2048, 2352, 4096):
        jsr, jsi = joneshot.superframe(jr, jipx, kf_cap=max(1, block // jipx))
        tsr, tsi = toneshot.superframe(tr, tipx, kf_cap=max(1, block // tipx))
        assert jsi == tsi and np.array_equal(jsr, tsr), block


def test_main_path_geometry():
    """44.1k->48k HIGH: R is [160, 343] over 147 inputs, lam 0, and the
    superframe is the identity (W - I = 196 <= 1.5 * 147)."""
    tp = tplan.plan_engine(44100, 48000, TQuality.HIGH)
    r, p2, ipx, lam = toneshot._fused_rational_matrix(tp)
    assert (r.shape, p2, ipx, lam) == ((160, 343), 160, 147, 0)
    assert tp.aa_taps == 0
    nnz = np.count_nonzero(r, axis=1)
    assert nnz.min() == 196 and nnz.max() == 197
    rs, ipxs = toneshot.superframe(r, ipx, kf_cap=2352 // 147)
    assert rs is r and ipxs == ipx


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("rates", RATES)
def test_plan_from_arrays_round_trip(rates, q):
    jp, tp = _plans(rates, q)
    fields = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    built = tplan.plan_from_arrays(fields)
    assert isinstance(built, tplan.EnginePlan)
    assert isinstance(built.quality, TQuality)
    assert isinstance(built.lengths, tplan.LengthModel)
    _assert_same_plan(tp, built)
    if built.is_rational_exact:
        a = toneshot._fused_rational_matrix(built)
        b = toneshot._fused_rational_matrix(tp)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]


def test_plan_from_arrays_copies_arrays():
    jp = jplan.plan_engine(44100, 48000, JQuality.HIGH)
    fields = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    built = tplan.plan_from_arrays(fields)
    assert built.bank_a is not jp.bank_a
    assert np.array_equal(built.bank_a, jp.bank_a)


def test_strict_antialias_matrix_not_ported():
    """The strict-antialias prefilter composed into the fused matrix
    (``pipeline/fused.compose``) is bit-equal to the JAX package's: R
    [147, 841] over 160 inputs with the prefilter's context lam = 245."""
    jp, tp = _plans((48000, 44100), JQuality.HIGH, strict_antialias=True)
    assert tp.is_rational_exact and tp.aa_taps == 491
    jr, jp2, jipx, jlam = joneshot._fused_rational_matrix(jp)
    tr, tp2, tipx, tlam = toneshot._fused_rational_matrix(tp)
    assert (tr.shape, tp2, tipx, tlam) == ((147, 841), 147, 160, 245)
    assert (jp2, jipx, jlam) == (tp2, tipx, tlam)
    assert jr.dtype == tr.dtype and np.array_equal(jr, tr)


@pytest.mark.parametrize("rates", [
    (float('nan'), 48000), (44100, math.inf), (0, 48000), (-1, 48000),
    (48000, 100), (100, 48000),
])
def test_config_errors_match(rates):
    with pytest.raises(jplan.EngineConfigError) as je:
        jplan.plan_engine(*rates, JQuality.HIGH)
    with pytest.raises(tplan.EngineConfigError) as te:
        tplan.plan_engine(*rates, TQuality.HIGH)
    assert str(je.value) == str(te.value)


def test_ratio_limits_equal():
    assert (jplan.MIN_RATIO, jplan.MAX_RATIO) == (tplan.MIN_RATIO,
                                                  tplan.MAX_RATIO)
