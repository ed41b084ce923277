"""PyTorch port vs JAX package: the torchaudio shim (``torch_compat``).

The port runs its one-shot on ``device='cpu'``, on torch tensors end to
end (no numpy round trip), and returns the result on the waveform's device
in its dtype.  Against the JAX package's shim on the CPU, fed the same
tensors: float64 outputs within 1e-12, shapes and dtypes equal.  The cases
of ``tests/test_torch_compat.py`` are carried over; its x64 warning case
has no counterpart (the port computes float64 on the CPU for float64
input, float32 on the card).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import go_audio_resampler_tpu as jar
import go_audio_resampler_tpu_torch as tar
from go_audio_resampler_tpu import torch_compat as JF
from go_audio_resampler_tpu_torch import torch_compat as F

RNG = np.random.default_rng(23)


def resample(x, inr, outr, **kw):
    return F.resample(x, inr, outr, device="cpu", **kw)


def Resample(*args, **kw):
    return F.Resample(*args, device="cpu", **kw)


def _native(x: np.ndarray, inr: float, outr: float,
            preset=tar.QualityPreset.HIGH) -> np.ndarray:
    y = tar.resample_mono(x.astype(np.float64), inr, outr, preset,
                          device="cpu")
    n_out = int(math.ceil(x.shape[-1] * outr / inr))
    if y.shape[0] >= n_out:
        return y[:n_out]
    return np.concatenate([y, np.zeros(n_out - y.shape[0])])


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000),
                                   (44100, 48001), (8000, 96000)])
@pytest.mark.parametrize("preset", [0, 3, 4])
def test_matches_jax(rates, preset):
    x = torch.from_numpy(RNG.standard_normal((2, 3, 1500)) * 0.5)
    want = JF.resample(x, *rates, quality=jar.QualityPreset(preset))
    got = resample(x, *rates, quality=tar.QualityPreset(preset))
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_transform_matches_jax():
    x = torch.from_numpy(RNG.standard_normal((4, 2000)) * 0.5)
    want = JF.Resample(48000, 16000, dtype=torch.float32)(x)
    got = Resample(48000, 16000, dtype=torch.float32)(x)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert repr(Resample(44100, 48000)) == repr(JF.Resample(44100, 48000))


def test_result_on_the_waveforms_device_and_no_grad():
    x = torch.from_numpy(RNG.standard_normal((2, 1000))).requires_grad_()
    y = resample(x, 44100, 48000)
    assert y.device == x.device and not y.requires_grad
    plan = tar.plan_engine(44100.0, 48000.0, tar.Quality.HIGH)
    ref = tar.oneshot(plan, x.detach(), device="cpu")[:, :y.shape[1]]
    assert torch.equal(y, ref)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        F.resample(torch.zeros(100), 44100, 48000)
    with pytest.raises(RuntimeError, match="CUDA"):
        F.Resample(44100, 48000)(torch.zeros(100))


# -- carried over: tests/test_torch_compat.py ---------------------------------

class TestFunctional:

    def test_mono_matches_native(self):
        x = (RNG.standard_normal(5000) * 0.5).astype(np.float64)
        y = resample(torch.from_numpy(x), 44100, 48000)
        ref = _native(x, 44100.0, 48000.0)
        assert y.shape == (ref.shape[0],)
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12, atol=1e-13)

    def test_length_convention_is_ceil(self):
        for n, inr, outr in [(5000, 44100, 48000), (4411, 48000, 44100),
                             (700, 96000, 48000), (1, 8000, 96000)]:
            y = resample(torch.zeros(n), inr, outr)
            assert y.shape[-1] == math.ceil(n * outr / inr), (n, inr, outr)

    def test_leading_dims_flattened(self):
        x = (RNG.standard_normal((3, 2, 2000)) * 0.5).astype(np.float64)
        y = resample(torch.from_numpy(x), 48000, 32000)
        assert y.shape[:2] == (3, 2)
        for i in range(3):
            for j in range(2):
                np.testing.assert_allclose(
                    y[i, j].numpy(), _native(x[i, j], 48000.0, 32000.0),
                    rtol=1e-12, atol=1e-13)

    def test_float32_roundtrip_dtype(self):
        x = torch.from_numpy(
            (RNG.standard_normal(3000) * 0.5).astype(np.float32))
        assert resample(x, 44100, 48000).dtype == torch.float32

    def test_float64_computes_float64_on_the_cpu(self):
        x = (RNG.standard_normal(2000) * 0.5).astype(np.float64)
        y = resample(torch.from_numpy(x), 44100, 48000)
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), _native(x, 44100.0, 48000.0),
                                   rtol=0, atol=1e-12)

    def test_equal_rates_identity(self):
        x = torch.from_numpy(RNG.standard_normal(100))
        assert resample(x, 48000, 48000) is x

    def test_zero_length(self):
        assert resample(torch.zeros(2, 0), 44100, 48000).shape == (2, 0)

    def test_signature_validation(self):
        x = torch.zeros(100)
        with pytest.raises(ValueError, match="method"):
            resample(x, 44100, 48000, resampling_method="nearest")
        with pytest.raises(ValueError, match="positive"):
            resample(x, -1, 48000)
        with pytest.raises(ValueError, match="width"):
            resample(x, 44100, 48000, lowpass_filter_width=0)
        with pytest.raises(ValueError, match="Rolloff"):
            resample(x, 44100, 48000, rolloff=1.5)
        with pytest.raises(TypeError, match="float"):
            resample(torch.zeros(10, dtype=torch.int16), 44100, 48000)
        with pytest.raises(TypeError, match="Tensor"):
            resample(np.zeros(10), 44100, 48000)

    def test_quality_keyword(self):
        x = (RNG.standard_normal(4000) * 0.5).astype(np.float64)
        y = resample(torch.from_numpy(x), 44100, 48000,
                     quality=tar.QualityPreset.LOW)
        ref = _native(x, 44100.0, 48000.0, tar.QualityPreset.LOW)
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12, atol=1e-13)


class TestTransform:

    def test_matches_functional(self):
        x = torch.from_numpy(
            (RNG.standard_normal((2, 3000)) * 0.5).astype(np.float64))
        t = Resample(orig_freq=44100, new_freq=48000)
        assert torch.equal(t(x), resample(x, 44100, 48000))

    def test_default_is_identity(self):
        x = torch.from_numpy(RNG.standard_normal(50))
        assert Resample()(x) is x

    def test_dtype_cast(self):
        x = torch.from_numpy(
            (RNG.standard_normal(1000) * 0.5).astype(np.float32))
        assert Resample(44100, 48000, dtype=torch.float64)(x).dtype == \
            torch.float64

    def test_repr(self):
        assert "44100" in repr(Resample(44100, 48000))

    def test_reuse_many_calls(self):
        t = Resample(48000, 16000)
        for n in (1000, 2000, 1000):
            x = torch.from_numpy(
                (RNG.standard_normal(n) * 0.5).astype(np.float64))
            assert t(x).shape[-1] == math.ceil(n / 3)

    def test_not_a_tensor_rejected(self):
        with pytest.raises(TypeError, match="Tensor"):
            Resample(44100, 48000)(np.zeros(10))


class TestQuality:

    def test_tone_preserved(self):
        n = 44100
        t = np.arange(n) / 44100.0
        x = torch.from_numpy(
            (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float64))
        y = resample(x, 44100, 48000).numpy()
        seg = y[4000:36768]
        w = np.hanning(seg.size)
        f = np.fft.rfftfreq(seg.size, 1 / 48000)[
            np.argmax(np.abs(np.fft.rfft(seg * w)))]
        assert abs(f - 1000.0) < 2.0, f


class TestHalfPrecision:

    @pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
    def test_half_dtypes_compute_at_f32(self, dt):
        x32 = (RNG.standard_normal((2, 2000)) * 0.5).astype(np.float32)
        x = torch.from_numpy(x32).to(dt)
        y = resample(x, 44100, 48000)
        assert y.dtype == dt and y.shape == (2, 2177)
        ref = resample(x.float(), 44100, 48000)
        err = (y.float() - ref).abs().max().item()
        assert err < (0.02 if dt == torch.bfloat16 else 0.002), err
