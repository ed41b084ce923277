"""Drop-in ``torchaudio``-style resampling API (PyTorch compatibility).

PyTorch counterpart of the JAX package's ``torch_compat.py``.  The other
large population of switchable resampler users lives on
``torchaudio.functional.resample`` / ``torchaudio.transforms.Resample``;
this shim offers their exact call surface over this package's engine so
migrating is an import change::

    # import torchaudio.functional as F
    from go_audio_resampler_tpu_torch import torch_compat as F

    y = F.resample(waveform, 44100, 48000)          # torch in, torch out

    # transform style (plan built once, reused per call):
    resampler = F.Resample(orig_freq=44100, new_freq=48000)
    y = resampler(waveform)

Conventions follow torchaudio:

- ``waveform`` is a ``torch.Tensor`` shaped ``[..., time]`` on any device;
  any number of leading dims (they are flattened into the engine's stream
  axis: one one-shot call resamples every channel/batch element).  The
  one-shot runs on ``device`` (``'cuda'`` by default, or ``'cpu'``) with
  no numpy round trip; the result comes back on the waveform's device.
- The output has ``ceil(time * new_freq / orig_freq)`` frames
  (torchaudio's length convention; this package's canonical full-flush
  stream is trimmed/zero-padded to it) and the input's float dtype.  The
  one-shot computes float32 on the card, and on the CPU float64 for
  float64 input, float32 for the other float types.
- ``orig_freq == new_freq`` returns the input unchanged.

Deviations (documented, by design):

- ``lowpass_filter_width``, ``rolloff``, ``resampling_method`` and
  ``beta`` parametrize torchaudio's windowed-sinc design; this engine
  always uses the soxr Kaiser designs, whose quality envelope exceeds
  every torchaudio setting (THD <= -130 dB vs ~-70 dB for torchaudio's
  default width-6 sinc).  The arguments are accepted and validated for
  signature compatibility but do not alter the filter; select the
  envelope with the extra ``quality=`` keyword (a
  :class:`~go_audio_resampler_tpu_torch.api.QualityPreset`, default HIGH).
- Gradients do not flow through this shim, as in the JAX package's.  For
  differentiable resampling use
  :func:`go_audio_resampler_tpu_torch.resample` (exact adjoint).

Reference anchors: quality-string mapping resample.go:104-131; one-shot
semantics convenience.go:204-229.
"""

from __future__ import annotations

import math

import torch

from .api import QualityPreset
from .convenience import preset_to_engine_quality
from .engine import plan_engine
from .engine.oneshot import oneshot as _engine_oneshot

__all__ = ["resample", "Resample"]

_METHODS = ("sinc_interp_hann", "sinc_interp_kaiser")


def _validate(orig_freq, new_freq, lowpass_filter_width, rolloff,
              resampling_method):
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError(
            f"frequencies must be positive, got {orig_freq} -> {new_freq}")
    if resampling_method not in _METHODS:
        raise ValueError(
            f"Invalid resampling method: {resampling_method}")
    if lowpass_filter_width <= 0:
        raise ValueError("Low pass filter width should be positive.")
    if not 0.0 < rolloff <= 1.0:
        raise ValueError("Rolloff value must be in the range (0, 1].")


def _run(x: torch.Tensor, plan, n_out: int, dtype, device) -> torch.Tensor:
    """Batched engine one-shot, trimmed/padded to torchaudio's length."""
    y = _engine_oneshot(plan, x, dtype=dtype, device=device)
    if y.shape[1] >= n_out:
        return y[:, :n_out]
    return torch.cat([y, y.new_zeros((y.shape[0], n_out - y.shape[1]))],
                     dim=1)


def resample(waveform, orig_freq: float, new_freq: float,
             lowpass_filter_width: int = 6, rolloff: float = 0.9945,
             resampling_method: str = "sinc_interp_hann",
             beta: float | None = None, *,
             quality: QualityPreset = QualityPreset.HIGH, device='cuda'):
    """torchaudio.functional.resample signature over this engine;
    ``device``: where the one-shot runs."""
    _validate(orig_freq, new_freq, lowpass_filter_width, rolloff,
              resampling_method)
    if float(orig_freq) == float(new_freq):
        if not isinstance(waveform, torch.Tensor):
            raise TypeError(
                f"expected a torch.Tensor, got {type(waveform)!r}")
        return waveform
    plan = plan_engine(float(orig_freq), float(new_freq),
                       preset_to_engine_quality(quality))
    return _apply(waveform, plan, float(orig_freq), float(new_freq), device)


def _apply(waveform, plan, orig_freq: float, new_freq: float, device):
    """Run a prebuilt plan over a torch waveform ([..., time])."""
    if not isinstance(waveform, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(waveform)!r}")
    if not waveform.is_floating_point():
        raise TypeError(
            f"expected a float waveform, got {waveform.dtype} "
            "(torchaudio's resample also requires floating point)")
    lead = waveform.shape[:-1]
    n = waveform.shape[-1]
    n_out = int(math.ceil(n * new_freq / orig_freq))
    if n == 0:
        return waveform.new_zeros(lead + (0,))
    device = torch.device(device)
    # The card's kernels compute float32; the CPU keeps float64 and
    # computes the other float types (half, bfloat16) at float32.
    comp = (waveform.dtype if device.type == 'cpu'
            and waveform.dtype == torch.float64 else torch.float32)
    y = _run(waveform.detach().reshape(-1, n), plan, n_out, comp, device)
    return y.reshape(lead + (n_out,)).to(device=waveform.device,
                                         dtype=waveform.dtype)


class Resample:
    """torchaudio.transforms.Resample signature over this engine.

    Builds the conversion plan once at construction (the transform
    pattern: one instance reused across many calls); each call runs one
    batched device program over all leading dims.
    """

    def __init__(self, orig_freq: float = 16000, new_freq: float = 16000,
                 resampling_method: str = "sinc_interp_hann",
                 lowpass_filter_width: int = 6, rolloff: float = 0.9945,
                 beta: float | None = None, *, dtype=None,
                 quality: QualityPreset = QualityPreset.HIGH,
                 device='cuda'):
        _validate(orig_freq, new_freq, lowpass_filter_width, rolloff,
                  resampling_method)
        self.orig_freq = float(orig_freq)
        self.new_freq = float(new_freq)
        self.resampling_method = resampling_method
        self.lowpass_filter_width = lowpass_filter_width
        self.rolloff = rolloff
        self.beta = beta
        self.quality = quality
        self._dtype = dtype
        self.device = device
        self._plan = None
        if self.orig_freq != self.new_freq:
            self._plan = plan_engine(self.orig_freq, self.new_freq,
                                     preset_to_engine_quality(quality))

    def __call__(self, waveform):
        if not isinstance(waveform, torch.Tensor):
            raise TypeError(
                f"expected a torch.Tensor, got {type(waveform)!r}")
        if self._plan is None:
            return waveform
        y = _apply(waveform, self._plan, self.orig_freq, self.new_freq,
                   self.device)
        if self._dtype is not None:
            y = y.to(self._dtype)
        return y

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(orig_freq={self.orig_freq:.0f}, "
                f"new_freq={self.new_freq:.0f}, quality={self.quality.name})")
