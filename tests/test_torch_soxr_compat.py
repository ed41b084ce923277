"""PyTorch port vs JAX package: the python-soxr shim (``soxr_compat``).

The port runs on ``device='cpu'``.  Against the JAX package's shim on the
CPU, fed the same numpy arrays: float64 outputs within 1e-12, integer
outputs equal, layouts, dtypes and lengths equal.  The cases of
``tests/test_soxr_compat.py`` are carried over; its x64 warning case has
no counterpart: the port computes float32 on the card and float64 on the
CPU (``_compute_dtype``), with no process-wide switch to warn about.
"""

import numpy as np
import pytest

from go_audio_resampler_tpu import soxr_compat as jsoxr
from go_audio_resampler_tpu_torch import convenience
from go_audio_resampler_tpu_torch import soxr_compat as soxr


def resample(x, inr, outr, quality="HQ"):
    return soxr.resample(x, inr, outr, quality=quality, device="cpu")


def stream(*args, **kw):
    return soxr.ResampleStream(*args, device="cpu", **kw)


def _sine(n, rate, freq=997.0, dtype=np.float32):
    t = np.arange(n) / rate
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(dtype)


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("quality", ["QQ", "LQ", "MQ", "HQ", "VHQ"])
@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000),
                                   (44100, 48001)])
def test_resample_matches_jax(rates, quality):
    x = np.random.default_rng(1).standard_normal((1500, 2)) * 0.5
    want = jsoxr.resample(x, *rates, quality=quality)
    got = resample(x, *rates, quality=quality)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dt", [np.int16, np.int32, np.float32])
def test_resample_dtypes_match_jax(dt):
    xf = _sine(4000, 44100, dtype=np.float64)
    x = (np.round(xf * 30000).astype(dt) if np.dtype(dt).kind == "i"
         else xf.astype(dt))
    want = jsoxr.resample(x, 44100, 48000)
    got = resample(x, 44100, 48000)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dt == np.int32:                 # float64 compute: exact
        np.testing.assert_array_equal(got, want)
    elif dt == np.int16:
        # float32 compute: within float32 parity (2e-5 of full scale is
        # 0.66 LSB), so a sample at a rounding boundary may move 1 LSB
        np.testing.assert_allclose(got.astype(np.int32),
                                   want.astype(np.int32), rtol=0, atol=1)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_stream_matches_jax():
    x = np.random.default_rng(2).standard_normal((9000, 2)) * 0.5
    j = jsoxr.ResampleStream(48000, 44100, 2, dtype="float64")
    t = stream(48000, 44100, 2, dtype="float64")
    want = np.concatenate([j.resample_chunk(x[:5000]),
                           j.resample_chunk(x[5000:], last=True)])
    got = np.concatenate([t.resample_chunk(x[:5000]),
                          t.resample_chunk(x[5000:], last=True)])
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_compute_dtype_follows_the_device():
    for dt, cpu in ((np.float32, np.float32), (np.int16, np.float32),
                    (np.float64, np.float64), (np.int32, np.float64)):
        assert soxr._compute_dtype(np.dtype(dt), "cpu") is cpu
        assert soxr._compute_dtype(np.dtype(dt), "cuda") is np.float32


# -- carried over: tests/test_soxr_compat.py ----------------------------------

class TestResampleOneShot:
    def test_mono_matches_convenience(self):
        x = _sine(20000, 44100, dtype=np.float64)
        y = resample(x, 44100, 48000, quality="HQ")
        ref = convenience.resample_mono(
            x, 44100, 48000, quality=soxr._QUALITY_MAP["HQ"], device="cpu")
        np.testing.assert_allclose(y, ref, rtol=0, atol=1e-12)

    def test_stereo_frame_major_channels_independent(self):
        l = _sine(8000, 44100, 500.0)
        r = _sine(8000, 44100, 1500.0)
        x = np.stack([l, r], axis=1)                 # [n, 2]
        y = resample(x, 44100, 48000)
        assert y.ndim == 2 and y.shape[1] == 2
        np.testing.assert_array_equal(y[:, 0], resample(l, 44100, 48000))
        np.testing.assert_array_equal(y[:, 1], resample(r, 44100, 48000))

    def test_dtype_preserved(self):
        for dt in (np.float32, np.float64):
            y = resample(_sine(4000, 48000, dtype=dt), 48000, 32000)
            assert y.dtype == dt

    def test_int16_round_trip_scaling(self):
        xf = _sine(8000, 44100, dtype=np.float64)
        xi = np.round(xf * 32768.0).clip(-32768, 32767).astype(np.int16)
        yi = resample(xi, 44100, 48000)
        assert yi.dtype == np.int16
        yf = resample(xi.astype(np.float64) / 32768.0, 44100, 48000)
        np.testing.assert_allclose(yi.astype(np.float64) / 32768.0, yf,
                                   atol=1.0 / 32768.0)

    @pytest.mark.parametrize("q,preset_name", [
        ("QQ", "QUICK"), ("lq", "LOW"), ("MQ", "MEDIUM"),
        ("HQ", "HIGH"), ("VHQ", "VERY_HIGH"),
        (0, "QUICK"), (4, "VERY_HIGH"),
    ])
    def test_quality_mapping(self, q, preset_name):
        assert soxr._preset(q).name == preset_name

    def test_unknown_quality_raises(self):
        with pytest.raises(ValueError, match="quality"):
            resample(_sine(100, 48000), 48000, 44100, quality="ULTRA")

    def test_bad_shapes_and_dtypes(self):
        with pytest.raises(ValueError):
            resample(np.zeros((4, 2, 2), np.float32), 48000, 44100)
        with pytest.raises(TypeError):
            resample(np.zeros(16, np.complex64), 48000, 44100)

    def test_default_device_without_cuda_raises(self):
        import torch
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            soxr.resample(_sine(100, 48000), 48000, 44100)
        with pytest.raises(RuntimeError, match="CUDA"):
            soxr.ResampleStream(48000, 44100, 1)


class TestResampleStream:
    def test_chunked_equals_oneshot(self):
        x = _sine(30000, 44100, dtype=np.float32)
        st = stream(44100, 48000, 1, dtype="float32", quality="HQ")
        outs = [st.resample_chunk(x[i:i + 7000]) for i in
                range(0, len(x), 7000)]
        outs.append(st.resample_chunk(np.zeros(0, np.float32), last=True))
        y = np.concatenate(outs)
        ref = resample(x, 44100, 48000, quality="HQ")
        assert y.shape == ref.shape
        # identical walk and coefficients; the sums' order differs at
        # float32 rounding only
        np.testing.assert_allclose(y, ref, rtol=0, atol=4e-6)

    def test_stereo_stream_shapes(self):
        x = np.stack([_sine(9000, 48000, 300.0),
                      _sine(9000, 48000, 800.0)], axis=1)
        st = stream(48000, 44100, 2)
        y = np.concatenate([st.resample_chunk(x[:5000]),
                            st.resample_chunk(x[5000:], last=True)], axis=0)
        ref = resample(x.astype(np.float32), 48000, 44100)
        assert y.shape == ref.shape
        np.testing.assert_allclose(y, ref, rtol=0, atol=4e-6)

    def test_after_last_raises_and_clear_recovers(self):
        st = stream(48000, 44100, 1)
        x = _sine(4000, 48000)
        a1 = [st.resample_chunk(x), st.resample_chunk(x, last=True)]
        with pytest.raises(RuntimeError, match="flushed"):
            st.resample_chunk(x)
        st.clear()
        a2 = [st.resample_chunk(x), st.resample_chunk(x, last=True)]
        np.testing.assert_array_equal(np.concatenate(a1),
                                      np.concatenate(a2))

    def test_wrong_chunk_shape_raises(self):
        st = stream(48000, 44100, 2)
        with pytest.raises(ValueError, match="chunk"):
            st.resample_chunk(np.zeros(100, np.float32))

    def test_int16_stream(self):
        x = np.round(_sine(8000, 44100, dtype=np.float64)
                     * 32768.0).clip(-32768, 32767).astype(np.int16)
        st = stream(44100, 48000, 1, dtype="int16")
        y = np.concatenate([st.resample_chunk(x[:4000]),
                            st.resample_chunk(x[4000:], last=True)])
        assert y.dtype == np.int16
        ref = resample(x, 44100, 48000)
        np.testing.assert_allclose(y.astype(np.int32),
                                   ref.astype(np.int32), atol=1)

    def test_bad_channels(self):
        with pytest.raises(ValueError):
            stream(48000, 44100, 0)
        with pytest.raises(TypeError):
            stream(48000, 44100, 1, dtype="int8")

    def test_mono_stream_accepts_column_chunks(self):
        x = _sine(4000, 48000)
        a = stream(48000, 44100, 1)
        b = stream(48000, 44100, 1)
        ya = np.concatenate([a.resample_chunk(x),
                             a.resample_chunk(x[:0], last=True)])
        yb = np.concatenate([b.resample_chunk(x[:, None]),
                             b.resample_chunk(x[:0], last=True)])
        np.testing.assert_array_equal(ya, yb)


class TestIntPrecisionPaths:
    def test_int32_unity_roundtrip_exact(self):
        """int32 computes at float64 on the CPU (python-soxr's double
        path): a unity-ratio pass-through returns >24-bit values
        exactly."""
        rng = np.random.default_rng(12)
        x = rng.integers(-2**31, 2**31 - 1, size=4096, dtype=np.int32)
        y = resample(x, 48000, 48000)
        assert y.dtype == np.int32
        np.testing.assert_array_equal(y[:len(x)], x)

    def test_int16_unity_roundtrip_exact(self):
        rng = np.random.default_rng(13)
        x = rng.integers(-32768, 32767, size=4096, dtype=np.int16)
        y = resample(x, 48000, 48000)
        assert y.dtype == np.int16
        np.testing.assert_array_equal(y[:len(x)], x)
