"""PyTorch port vs JAX package: filter design, test signals and metrics.

The port keeps numpy copies of these host modules (importing the JAX
package would pull in JAX); every array they return must equal the
reference's bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from go_audio_resampler_tpu import filterdesign as jfd
from go_audio_resampler_tpu.filterdesign import bessel as jbessel
from go_audio_resampler_tpu.filterdesign import kaiser as jkaiser
from go_audio_resampler_tpu.filterdesign import params as jparams
from go_audio_resampler_tpu.pipeline.buffer import SampleFIFO as JFIFO
from go_audio_resampler_tpu.utils import metrics as jmetrics
from go_audio_resampler_tpu.utils import signals as jsignals
from go_audio_resampler_tpu_torch import filterdesign as tfd
from go_audio_resampler_tpu_torch.filterdesign import bessel as tbessel
from go_audio_resampler_tpu_torch.filterdesign import kaiser as tkaiser
from go_audio_resampler_tpu_torch.filterdesign import params as tparams
from go_audio_resampler_tpu_torch.pipeline.buffer import SampleFIFO as TFIFO
from go_audio_resampler_tpu_torch.utils import metrics as tmetrics
from go_audio_resampler_tpu_torch.utils import signals as tsignals

QUALITIES = [q.value for q in jfd.Quality]


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_exports_match():
    assert sorted(jfd.__all__) == sorted(tfd.__all__)
    assert [(q.name, q.value) for q in jfd.Quality] == \
        [(q.name, q.value) for q in tfd.Quality]


@pytest.mark.parametrize("fn", ["bessel_i0", "bessel_i1", "bessel_i0_ratio",
                                "kaiser_beta", "kaiser_attenuation"])
def test_bessel_scalars_equal(fn):
    for x in [0.0, 1e-12, 0.3, 3.74, 3.75, 7.0, 49.0, 51.0, 120.0, 800.0,
              -2.5, -60.0]:
        assert getattr(jbessel, fn)(x) == getattr(tbessel, fn)(x), x


def test_bessel_array_and_length_equal():
    x = np.linspace(-40.0, 700.0, 1001)
    _eq(jbessel.bessel_i0_array(x), tbessel.bessel_i0_array(x))
    for att in (20.0, 60.0, 126.4, 180.0):
        for tr in (0.0, 1e-4, 0.005, 0.05):
            assert jbessel.kaiser_beta_with_tr_bw(att, tr) == \
                tbessel.kaiser_beta_with_tr_bw(att, tr)
            assert jbessel.estimate_filter_length(att, tr) == \
                tbessel.estimate_filter_length(att, tr)


@pytest.mark.parametrize("length", [0, 1, 2, 17, 255, 8191, 9001])
def test_kaiser_window_equal(length):
    for beta in (0.0, 5.6, 12.9):
        _eq(jkaiser.kaiser_window(length, beta),
            tkaiser.kaiser_window(length, beta))


def test_lowpass_and_response_equal():
    p = dict(num_taps=101, cutoff_freq=0.2, attenuation=120.0, gain=1.0)
    h = jkaiser.design_lowpass(jkaiser.FilterParams(**p))
    _eq(h, tkaiser.design_lowpass(tkaiser.FilterParams(**p)))
    _eq(jkaiser.design_lowpass_auto(0.1, 0.01, 100.0),
        tkaiser.design_lowpass_auto(0.1, 0.01, 100.0))
    jr = jkaiser.frequency_response(h, 257)
    tr = tkaiser.frequency_response(h, 257)
    for f in ("frequencies", "magnitude", "phase"):
        _eq(getattr(jr, f), getattr(tr, f))
    for m in (0.0, 1e-12, 0.5, 3.0):
        assert jkaiser.magnitude_db(m) == tkaiser.magnitude_db(m)


@pytest.mark.parametrize("bad", [
    dict(num_taps=2, cutoff_freq=0.2, attenuation=60.0),
    dict(num_taps=9000, cutoff_freq=0.2, attenuation=60.0),
    dict(num_taps=11, cutoff_freq=0.5, attenuation=60.0),
    dict(num_taps=11, cutoff_freq=0.2, attenuation=-1.0),
    dict(num_taps=11, cutoff_freq=0.2, attenuation=600.0),
    dict(num_taps=11, cutoff_freq=0.2, attenuation=60.0, gain=0.0),
])
def test_filter_params_validation_matches(bad):
    with pytest.raises(jkaiser.FilterDesignError) as je:
        jkaiser.FilterParams(**bad).validate()
    with pytest.raises(tkaiser.FilterDesignError) as te:
        tkaiser.FilterParams(**bad).validate()
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("q", QUALITIES)
def test_quality_params_equal(q):
    assert jparams.quality_to_attenuation(q) == \
        tparams.quality_to_attenuation(q)
    assert jparams.quality_to_passband_end(q) == \
        tparams.quality_to_passband_end(q)
    att = jparams.quality_to_attenuation(q)
    for drop in (-0.01, -3.0, -100.0):
        assert jparams.lsx_inv_f_resp(drop, att) == \
            tparams.lsx_inv_f_resp(drop, att)
    for args in [(80, 0.5442, 0.91875, True), (160, 1.0884, 1.08844, False),
                 (64, 0.3333, 3.0, True)]:
        pe = jparams.quality_to_passband_end(q)
        a = jparams.compute_polyphase_filter_params(*args, att, pe)
        b = tparams.compute_polyphase_filter_params(*args, att, pe)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("q", QUALITIES)
def test_stage_designs_equal(q):
    for factor in (1, 2, 3):
        a = jparams.design_dft_upsample(factor, q)
        b = tparams.design_dft_upsample(factor, q)
        _eq(a.phase_coeffs, b.phase_coeffs)
        assert (a.factor, a.taps_per_phase, a.is_half_band,
                a.phase0_tap_offset, a.phase0_tap_scale) == \
            (b.factor, b.taps_per_phase, b.is_half_band,
             b.phase0_tap_offset, b.phase0_tap_scale)
        c = jparams.design_decimation(factor, q)
        d = tparams.design_decimation(factor, q)
        _eq(c.coeffs, d.coeffs)
        assert (c.factor, c.num_taps) == (d.factor, d.num_taps)
    e = jparams.design_antialias_prefilter(44100 / 48000, q)
    f = tparams.design_antialias_prefilter(44100 / 48000, q)
    _eq(e.coeffs, f.coeffs)
    assert (e.num_taps, e.delay) == (f.num_taps, f.delay)


@pytest.mark.parametrize("q", [jfd.Quality.LOW, jfd.Quality.HIGH,
                               jfd.Quality.VERY_HIGH])
def test_polyphase_design_and_banks_equal(q):
    ratio = 48000 / (44100 * 2)
    for hq in (0, 160):
        a = jparams.design_polyphase_filter(80, ratio, 44100 / 48000, True,
                                            q, hq_phases=hq)
        b = tparams.design_polyphase_filter(80, ratio, 44100 / 48000, True,
                                            q, hq_phases=hq)
        _eq(a.coeffs, b.coeffs)
        assert (a.num_phases, a.taps_per_phase) == \
            (b.num_phases, b.taps_per_phase)
        for wrap in (False, True):
            for x, y in zip(jparams.cubic_phase_banks(a, correct_wrap=wrap),
                            tparams.cubic_phase_banks(b, correct_wrap=wrap)):
                _eq(x, y)
    for r in (0.5, 48000 / 88200, 88200 / 48000, 1.0001, 0.3):
        assert jparams.find_rational_approx(r) == \
            tparams.find_rational_approx(r)
        assert jparams.polyphase_step(r, 80) == tparams.polyphase_step(r, 80)


@pytest.mark.parametrize("order", [0, 1, 3])
def test_standalone_polyphase_bank_equal(order):
    a = jfd.design_polyphase_bank(8, 20, 0.45, 100.0,
                                  jfd.InterpolationOrder(order))
    b = tfd.design_polyphase_bank(8, 20, 0.45, 100.0,
                                  tfd.InterpolationOrder(order))
    _eq(a.coeffs, b.coeffs)
    assert (a.num_phases, a.taps_per_phase, a.cutoff, a.attenuation) == \
        (b.num_phases, b.taps_per_phase, b.cutoff, b.attenuation)
    assert a.get_coefficient(3, 5, 0.37) == b.get_coefficient(3, 5, 0.37)
    assert a.phase_dc_gain(2) == b.phase_dc_gain(2)
    _eq(a.phase_response(1, 64).magnitude, b.phase_response(1, 64).magnitude)


def test_signals_equal():
    n = 4096
    _eq(jsignals.sine(n, 1000.0, 44100), tsignals.sine(n, 1000.0, 44100))
    _eq(jsignals.multitone(n, [300.0, 5000.0], 48000),
        tsignals.multitone(n, [300.0, 5000.0], 48000))
    ja, jf = jsignals.passband_tones(n, 44100, 48000)
    ta, tf = tsignals.passband_tones(n, 44100, 48000)
    _eq(ja, ta)
    assert jf == tf
    _eq(jsignals.alias_tones(n, 96000, 48000),
        tsignals.alias_tones(n, 96000, 48000))
    _eq(jsignals.white_noise(n, seed=7), tsignals.white_noise(n, seed=7))
    _eq(jsignals.impulse(n, 9), tsignals.impulse(n, 9))
    _eq(jsignals.dc(n, 0.25), tsignals.dc(n, 0.25))


def test_metrics_equal():
    rng = np.random.default_rng(3)
    y = jsignals.sine(20000, 1000.0, 48000) + 1e-6 * rng.normal(size=20000)
    for fn in ("thd", "snr"):
        assert getattr(jmetrics, fn)(y, 48000, 1000.0) == \
            getattr(tmetrics, fn)(y, 48000, 1000.0)
    a = jmetrics.passband_ripple(y, 48000, [500.0, 1000.0, 7000.0])
    b = tmetrics.passband_ripple(y, 48000, [500.0, 1000.0, 7000.0])
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    x = jsignals.alias_tones(20000, 96000, 48000)
    assert jmetrics.antialias_attenuation(x, y, 96000, 48000) == \
        tmetrics.antialias_attenuation(x, y, 96000, 48000)
    assert jmetrics.dc_gain(y) == tmetrics.dc_gain(y)
    assert jmetrics.amplitude(y) == tmetrics.amplitude(y)


def test_sample_fifo_equal():
    rng = np.random.default_rng(5)
    a, b = JFIFO(3, capacity=4), TFIFO(3, capacity=4)
    for step in range(40):
        n = int(rng.integers(0, 9))
        chunk = rng.normal(size=(3, n))
        a.write(chunk)
        b.write(chunk)
        k = int(rng.integers(0, 7))
        _eq(a.read(k), b.read(k))
        assert a.available() == b.available()
        if step % 9 == 0:
            dst_a, dst_b = np.zeros((3, 5)), np.zeros((3, 5))
            assert a.read_into(dst_a) == b.read_into(dst_b)
            _eq(dst_a, dst_b)
        _eq(a.snapshot(), b.snapshot())
    _eq(a.read_all(), b.read_all())
