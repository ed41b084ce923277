"""PyTorch port vs JAX package: the variable-rate resampler
(``engine/variable.py``; libsoxr SOXR_VR, beyond the Go reference).

The port runs on ``device='cpu'``.  Against the JAX package on the CPU,
fed the same numpy inputs: the outputs within 1e-12 in float64 (2e-5 in
float32), lengths and ``get_statistics`` equal, for ``'vr'`` and
``'vr-hq'`` mid-slew.  The cases of ``tests/test_variable_rate.py`` are
carried over to the port (structure, quality, construction, the device
mode), and a spy shows that ``process_device`` and ``flush_device`` read
nothing back from the device.  The card's cases are in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import go_audio_resampler_tpu as jar
import go_audio_resampler_tpu_torch as tar
from go_audio_resampler_tpu.engine.variable import \
    VariableRateResampler as JVR
from go_audio_resampler_tpu_torch.engine import variable
from go_audio_resampler_tpu_torch.engine.variable import \
    VariableRateResampler


def VR(*args, **kw):
    kw.setdefault("device", "cpu")
    return VariableRateResampler(*args, **kw)


def sine(n, cycles_per_sample, phase=0.0):
    return np.sin(2 * np.pi * cycles_per_sample * np.arange(n) + phase)


def ls_fit_tone(y, cycles_per_sample):
    """Least-squares amplitude/phase of a known-frequency tone."""
    t = np.arange(len(y))
    c = np.cos(2 * np.pi * cycles_per_sample * t)
    s = np.sin(2 * np.pi * cycles_per_sample * t)
    A = np.stack([c, s], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    amp = float(np.hypot(*coef))
    resid = y - A @ coef
    return amp, float(np.sqrt(np.mean(resid ** 2)))


# -- against the JAX package --------------------------------------------------

def _slewed_run(vr, x, cuts):
    """Feed ``x`` in pieces at ``cuts``, a slew set after the first."""
    outs, at = [], 0
    for i, c in enumerate(cuts + [x.shape[1]]):
        outs.append(vr.process(x[:, at:c]))
        at = c
        if i == 0:
            vr.set_io_ratio(1.3, slew_len=2000)
    outs.append(vr.flush())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-5)])
@pytest.mark.parametrize("quality", ["vr", "vr-hq"])
def test_matches_jax_mid_slew(quality, dtype, tol):
    x = (np.random.default_rng(3).standard_normal((2, 7000)) * 0.5).astype(
        dtype)
    kw = dict(batch=2, block=512, dtype=dtype, quality=quality)
    j, t = JVR(2.0, 0.9, **kw), VR(2.0, 0.9, **kw)
    want = _slewed_run(j, x, [1500, 3100])
    got = _slewed_run(t, x, [1500, 3100])
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))
    assert t.get_statistics() == j.get_statistics()
    assert (t.cap, t._delay_u, t.factor) == (j.cap, j._delay_u, j.factor)


def test_device_route_matches_jax_mid_slew():
    x = np.random.default_rng(4).standard_normal((2, 6 * 1024)) * 0.5
    kw = dict(batch=2, block=1024, dtype=np.float64, quality="vr-hq")
    j, t = JVR(2.0, 0.9, **kw), VR(2.0, 0.9, **kw)
    for v in (j, t):
        v.set_io_ratio(1.3, slew_len=2000)
    want = np.concatenate([np.asarray(j.process_device(x[:, :4096])),
                           np.asarray(j.process_device(x[:, 4096:])),
                           np.asarray(j.flush_device())], axis=1)
    got = torch.cat([t.process_device(torch.from_numpy(x[:, :4096])),
                     t.process_device(torch.from_numpy(x[:, 4096:])),
                     t.flush_device()], dim=1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_cubic_basis_matches_jax():
    from go_audio_resampler_tpu.engine import variable as jvariable
    fr = np.random.default_rng(5).random(1000)
    for dt in (np.float32, np.float64):
        want = np.asarray(jvariable._cubic_basis(fr.astype(dt)))
        got = variable._cubic_basis(fr.astype(dt))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_new_variable_rate_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 3000))
    j = jar.new_variable_rate(48000, 96000, output_rate=44100, channels=2,
                              dtype=np.float64, hq=True)
    t = tar.new_variable_rate(48000, 96000, output_rate=44100, channels=2,
                              dtype=np.float64, hq=True, device="cpu")
    assert isinstance(t, VariableRateResampler)
    assert (t.max_ratio, t.batch, t.quality) == (j.max_ratio, j.batch,
                                                 j.quality)
    want = np.concatenate([j.process(x), j.flush()], axis=1)
    got = np.concatenate([t.process(x), t.flush()], axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        VariableRateResampler(2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tar.new_variable_rate(48000, 96000)


def test_float64_refused_on_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            VariableRateResampler(2.0, dtype=np.float64, device="cuda")
        return
    with pytest.raises(ValueError, match="float64"):
        VariableRateResampler(2.0, dtype=np.float64, device="cuda")


def test_process_device_reads_nothing_back(monkeypatch):
    """Every count and slice bound comes from the host walk: no call in
    process_device / flush_device reads a tensor back (a spy on the
    tensor's host reads), even mid-slew."""
    dev = VR(2.0, 0.9, batch=2, block=1024, dtype=np.float64,
             quality="vr-hq")
    dev.set_io_ratio(1.1, slew_len=500)
    x = torch.from_numpy(np.random.default_rng(43)
                         .standard_normal((2, 4 * 1024)))

    def boom(*a, **k):
        raise AssertionError("device -> host read in device mode")
    for name in ("item", "cpu", "numpy", "tolist", "__array__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    y = dev.process_device(x)
    t = dev.flush_device()
    monkeypatch.undo()
    assert isinstance(y, torch.Tensor) and isinstance(t, torch.Tensor)
    assert y.shape[1] + t.shape[1] == dev.samples_out > 0


# -- carried over: tests/test_variable_rate.py --------------------------------

class TestStructure:
    def test_identity_ratio_exact(self):
        # io_ratio 1.0 positions land exactly on input samples: the cubic
        # with frac 0 reproduces the input bit for bit.
        x = sine(5000, 0.01)
        vr = VR(2.0, 1.0, dtype=np.float64, block=512)
        y = np.concatenate([vr.process(x)[0], vr.flush()[0]])
        assert len(y) == 5000
        np.testing.assert_array_equal(y[4:-4], x[4:-4])

    @pytest.mark.parametrize("r,exp", [(0.5, 10000), (2.0, 2500),
                                       (0.75, 6667), (1.25, 4000)])
    def test_output_counts(self, r, exp):
        x = np.zeros(5000)
        vr = VR(4.0, r, dtype=np.float64)
        y = np.concatenate([vr.process(x)[0], vr.flush()[0]])
        assert abs(len(y) - exp) <= 1, (len(y), exp)

    @pytest.mark.parametrize("quality", ["vr", "vr-hq"])
    @pytest.mark.parametrize("chunk", [1, 313, 997, 4096])
    def test_chunking_invariance(self, quality, chunk):
        rng = np.random.default_rng(5)
        x = rng.normal(size=4000)
        a = VR(4.0, 0.8, dtype=np.float64, quality=quality, block=512)
        ya = np.concatenate([a.process(x)[0], a.flush()[0]])
        b = VR(4.0, 0.8, dtype=np.float64, quality=quality, block=512)
        parts = [b.process(x[i:i + chunk])[0]
                 for i in range(0, len(x), chunk)]
        yb = np.concatenate(parts + [b.flush()[0]])
        assert ya.shape == yb.shape
        np.testing.assert_array_equal(ya, yb)

    def test_batch_streams_independent(self):
        # Each output is a fixed-order elementwise sum, so a lane's bits
        # do not depend on the batch (the JAX package holds it to 1 ulp).
        rng = np.random.default_rng(6)
        xs = rng.normal(size=(3, 3000))
        vr = VR(2.0, 1.1, batch=3, dtype=np.float64)
        y = np.concatenate([vr.process(xs), vr.flush()], axis=1)
        for i in range(3):
            solo = VR(2.0, 1.1, batch=1, dtype=np.float64)
            ys = np.concatenate([solo.process(xs[i])[0], solo.flush()[0]])
            np.testing.assert_array_equal(y[i], ys)

    def test_reset_reproducible(self):
        x = sine(2000, 0.013)
        vr = VR(2.0, 0.9, dtype=np.float64)
        vr.set_io_ratio(1.2, slew_len=500)
        y1 = np.concatenate([vr.process(x)[0], vr.flush()[0]])
        vr.reset()
        vr.set_io_ratio(1.2, slew_len=500)
        y2 = np.concatenate([vr.process(x)[0], vr.flush()[0]])
        np.testing.assert_array_equal(y1, y2)
        vr.reset()
        vr2 = VR(2.0, vr.get_io_ratio(), dtype=np.float64)
        assert np.isfinite(y1).all()
        stats = vr.get_statistics()
        assert stats["samplesIn"] == 0 and stats["samplesOut"] == 0
        assert vr2.get_io_ratio() == vr.get_io_ratio()

    def test_ratio_validation(self):
        with pytest.raises(ValueError):
            VR(500.0)
        with pytest.raises(ValueError):
            VR(2.0, 1 / 300.0)
        vr = VR(2.0, 1.0)
        with pytest.raises(ValueError):
            vr.set_io_ratio(0.25)       # output/input 4 > max_ratio 2
        with pytest.raises(ValueError):
            vr.set_io_ratio(300.0)
        with pytest.raises(ValueError, match="quality"):
            VR(2.0, quality="hq")
        with pytest.raises(ValueError, match="dtype"):
            VR(2.0, dtype=np.int16)

    def test_convenience_ctor(self):
        vr = tar.new_variable_rate(48000, 96000, output_rate=48000,
                                   channels=2, dtype=np.float64,
                                   device="cpu")
        assert vr.get_io_ratio() == 1.0 and vr.batch == 2
        x = np.zeros((2, 1000))
        y = np.concatenate([vr.process(x), vr.flush()], axis=1)
        assert y.shape[0] == 2 and abs(y.shape[1] - 1000) <= 1


class TestQuality:
    def test_constant_ratio_matches_quick_cubic_class(self):
        # Fixed-ratio VR against the constant-rate QUICK engine (both are
        # SOXR cr-core cubics): same length; tone amplitude within the
        # cubic class's tolerance of unity.
        f = 0.02
        x = sine(44100, f)
        vr = VR(2.0, 44100 / 48000, dtype=np.float64)
        y = np.concatenate([vr.process(x)[0], vr.flush()[0]])
        eng = tar.new_engine(44100, 48000, tar.QualityPreset.QUICK,
                             device="cpu")
        z = np.concatenate([eng.process(x), eng.flush()])
        assert abs(len(y) - len(z)) <= 2
        amp_y, _ = ls_fit_tone(y[100:-100], f * 44100 / 48000)
        amp_z, _ = ls_fit_tone(z[100:-100], f * 44100 / 48000)
        assert abs(amp_y - 1.0) < 5e-3
        assert abs(amp_y - amp_z) < 5e-3

    def test_hq_mode_cuts_interpolation_error(self):
        # A 0.2*fs tone stresses cubic interpolation; the 2x half-band
        # prestage must cut the residual by >= 20 dB.
        f = 0.2
        x = sine(48000, f)
        resid = {}
        for q in ("vr", "vr-hq"):
            vr = VR(2.0, 0.9, dtype=np.float64, quality=q)
            y = np.concatenate([vr.process(x)[0], vr.flush()[0]])
            _, resid[q] = ls_fit_tone(y[500:-500], f * 0.9)
        improvement_db = 20 * np.log10(resid["vr"] / resid["vr-hq"])
        assert improvement_db >= 20.0, improvement_db

    def test_glissando_tracks_instantaneous_frequency(self):
        # Slew the ratio 1.0 -> 0.5 over 20000 outputs while feeding a
        # fixed tone; the output's local frequency tracks f_in * r(t).
        f_in = 0.01
        x = sine(60000, f_in)
        vr = VR(4.0, 1.0, dtype=np.float64)
        vr.set_io_ratio(0.5, slew_len=20000)
        y = np.concatenate([vr.process(x)[0], vr.flush()[0]])
        for k0 in (2000, 8000, 14000, 30000):
            w = y[k0:k0 + 800]
            f_loc = f_in * (1.0 - 0.5 * min(k0 + 400, 20000) / 20000.0
                            if k0 + 400 < 20000 else 0.5)
            amp, resid = ls_fit_tone(w, f_loc)
            assert abs(amp - 1.0) < 0.05, (k0, amp)
            assert resid < 0.08, (k0, resid)

    def test_slew_continuity(self):
        # No discontinuity at slew boundaries: the output's second
        # difference stays bounded by the tone's own curvature scale.
        x = sine(30000, 0.005)
        vr = VR(4.0, 1.0, dtype=np.float64)
        y0 = vr.process(x[:10000])[0]
        vr.set_io_ratio(0.7, slew_len=5000)
        y1 = vr.process(x[10000:])[0]
        y = np.concatenate([y0, y1, vr.flush()[0]])
        d2 = np.abs(np.diff(y, 2))
        assert d2.max() < 10 * (2 * np.pi * 0.005) ** 2, d2.max()

    def test_drift_correction_usecase(self):
        # Clock-drift trim: +-100 ppm adjustments around unity keep the
        # stream close to the input (sub-sample resampling of a smooth
        # signal).
        x = sine(20000, 0.008)
        vr = VR(2.0, 1.0001, dtype=np.float64)
        y1 = vr.process(x[:10000])[0]
        vr.set_io_ratio(0.9999, slew_len=100)
        y2 = np.concatenate([vr.process(x[10000:])[0], vr.flush()[0]])
        y = np.concatenate([y1, y2])
        amp, resid = ls_fit_tone(y[200:9000], 0.008 * 1.0001)
        assert abs(amp - 1.0) < 1e-3 and resid < 1e-2


class TestConstruction:
    def test_initial_ratio_must_respect_max_ratio(self):
        with pytest.raises(ValueError, match="max_ratio"):
            VR(1.0, 0.5)

    def test_initial_ratio_within_max_ok(self):
        vr = VR(2.0, 0.5, block=256)
        y = vr.process(np.zeros(512, dtype=np.float32))
        assert y.shape[0] == 1 and y.dtype == np.float32


class TestDeviceMode:
    """The closed-form walk computes every count and slice bound on the
    host, so process_device/flush_device never synchronize, even across
    a mid-stream slew."""

    def _mk(self, **kw):
        kw.setdefault("batch", 2)
        kw.setdefault("block", 1024)
        kw.setdefault("dtype", np.float64)
        return VR(2.0, 0.9, **kw)

    @pytest.mark.parametrize("quality", ["vr", "vr-hq"])
    def test_parity_with_host_mid_slew(self, quality):
        rng = np.random.default_rng(41)
        x = rng.standard_normal((2, 6 * 1024)) * 0.5
        host = self._mk(quality=quality)
        host.set_io_ratio(1.3, slew_len=2000)
        ref = np.concatenate([host.process(x), host.flush()], axis=1)
        dev = self._mk(quality=quality)
        dev.set_io_ratio(1.3, slew_len=2000)
        got = torch.cat(
            [dev.process_device(torch.from_numpy(x[:, :4096])),
             dev.process_device(torch.from_numpy(x[:, 4096:])),
             dev.flush_device()], dim=1).numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)

    def test_contracts(self):
        dev = self._mk()
        with pytest.raises(ValueError, match="multiple"):
            dev.process_device(torch.zeros((2, 1000), dtype=torch.float64))
        with pytest.raises(ValueError, match="batch"):
            dev.process_device(torch.zeros((3, 1024), dtype=torch.float64))
        assert dev.device_chunk_multiple == 1024
        assert dev.process_device(torch.zeros((2, 0))).shape == (2, 0)
        dev.process(np.zeros((2, 100)))       # host-buffered remainder
        with pytest.raises(RuntimeError, match="pending"):
            dev.process_device(torch.zeros((2, 1024), dtype=torch.float64))

    def test_mixed_host_tail(self):
        # Host remainder after device chunks: flush_device folds it in.
        rng = np.random.default_rng(47)
        x = rng.standard_normal((2, 3000)) * 0.5
        host = self._mk()
        ref = np.concatenate([host.process(x), host.flush()], axis=1)
        dev = self._mk()
        outs = [dev.process_device(torch.from_numpy(x[:, :2048])).numpy()]
        outs.append(dev.process(x[:, 2048:]))     # 952 < block: buffered
        outs.append(dev.flush_device().numpy())
        got = np.concatenate([o for o in outs if o.size], axis=1)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)

    def test_stream_generator_parity(self):
        rng = np.random.default_rng(59)
        x = rng.standard_normal((2, 5000)) * 0.5
        host = self._mk()
        host.set_io_ratio(1.15, slew_len=800)
        ref = np.concatenate([host.process(x), host.flush()], axis=1)
        dev = self._mk()
        dev.set_io_ratio(1.15, slew_len=800)
        got = np.concatenate(list(dev.stream([x[:, :1333], x[:, 1333:4000],
                                              x[:, 4000:]])), axis=1)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)

    def test_stream_device_out(self):
        dev = self._mk()
        x = np.random.default_rng(61).standard_normal((2, 3 * 1024))
        outs = list(dev.stream([x], out='device'))
        assert outs and all(isinstance(o, torch.Tensor) for o in outs)

    def test_stream_with_prebuffered_host_input(self):
        # A sub-block hold and sub-block chunks that together cross a
        # block boundary: the shared protocol yields whatever the
        # remainder emits, in order.
        host = self._mk()
        x = np.random.default_rng(67).standard_normal((2, 1100)) * 0.5
        ref = np.concatenate(
            [host.process(x[:, :100]), host.process(x[:, 100:]),
             host.flush()], axis=1)
        dev = self._mk()
        assert dev.process(x[:, :100]).shape[1] == 0
        got = np.concatenate(list(dev.stream([x[:, 100:]])), axis=1)
        assert got.shape[1] == ref.shape[1]
        np.testing.assert_array_equal(got, ref)
