"""Drop-in ``soxr``-style API (python-soxr compatibility shim).

PyTorch counterpart of the JAX package's ``soxr_compat.py``.  The
reference library is itself a libsoxr re-implementation
(README.md:1-20); the dominant Python binding of libsoxr is
`python-soxr <https://github.com/dofuuz/python-soxr>`_, so offering its
exact call surface makes switching a one-line import change::

    # import soxr
    from go_audio_resampler_tpu_torch import soxr_compat as soxr

    y = soxr.resample(x, 48000, 44100, quality="HQ")

Conventions follow python-soxr, which differ from this package's native
API in two ways:

- Arrays are **frame-major**: ``[n]`` for mono or ``[n, channels]``
  interleaved-by-frame (the native API is stream-major ``[channels, n]``).
- Quality is a string/int: ``'QQ' 'LQ' 'MQ' 'HQ' 'VHQ'`` (or 0..4),
  mapped onto the same presets the reference maps them to
  (resample.go:104-131).

The output is this package's canonical fully-flushed stream, equal to
``convenience.resample_mono`` per channel (python-soxr also returns the
complete flushed signal for its one-shot ``resample``).  Both entry points
run on the card (``device='cuda'``) unless given ``device='cpu'``.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import QualityPreset
from .convenience import preset_to_engine_quality
from .engine import EngineCore, plan_engine
from .engine.oneshot import oneshot as _engine_oneshot

__all__ = ["resample", "ResampleStream", "QQ", "LQ", "MQ", "HQ", "VHQ"]

# python-soxr quality constants (soxr.h SOXR_QQ..SOXR_VHQ ordering).
QQ, LQ, MQ, HQ, VHQ = "QQ", "LQ", "MQ", "HQ", "VHQ"

_QUALITY_MAP = {
    "QQ": QualityPreset.QUICK,
    "LQ": QualityPreset.LOW,
    "MQ": QualityPreset.MEDIUM,
    "HQ": QualityPreset.HIGH,
    "VHQ": QualityPreset.VERY_HIGH,
    0: QualityPreset.QUICK,
    1: QualityPreset.LOW,
    2: QualityPreset.MEDIUM,
    3: QualityPreset.HIGH,
    4: QualityPreset.VERY_HIGH,
}


def _preset(quality) -> QualityPreset:
    key = quality.upper() if isinstance(quality, str) else quality
    try:
        return _QUALITY_MAP[key]
    except KeyError:
        raise ValueError(f"unknown quality {quality!r}; "
                         f"expected one of QQ LQ MQ HQ VHQ or 0..4") from None


def _check_dtype(x: np.ndarray) -> np.dtype:
    dt = np.dtype(x.dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        # python-soxr also accepts int16/int32 natively; normalize like
        # its internal conversion (scale to [-1, 1), convert back after).
        if dt in (np.dtype(np.int16), np.dtype(np.int32)):
            return dt
        raise TypeError(f"unsupported dtype {dt}; use float32/float64/"
                        f"int16/int32")
    return dt


def _compute_dtype(dt: np.dtype, device) -> type:
    """Engine compute dtype for an input dtype: f32 for f32/int16
    (int16 fits f32 losslessly); for f64/int32, python-soxr's double
    path, f64 on the CPU and f32 on the card, whose kernels compute
    float32 (int32 round-trips then lose low bits there)."""
    if dt in (np.dtype(np.float32), np.dtype(np.int16)):
        return np.float32
    return np.float32 if torch.device(device).type == 'cuda' else np.float64


def resample(x, in_rate: float, out_rate: float, quality="HQ",
             device='cuda') -> np.ndarray:
    """One-shot resample, python-soxr signature.

    ``x``: [n] mono or [n, channels] frame-major array (float32/float64,
    or int16/int32 which are scaled through float and converted back).
    Returns the same layout/dtype at ``out_rate``.  ``device``: where the
    one-shot runs (``'cuda'``, or ``'cpu'``).
    """
    preset = _preset(quality)
    x = np.asarray(x)
    if x.ndim not in (1, 2):
        raise ValueError(f"expected [n] or [n, channels], got shape {x.shape}")
    dt = _check_dtype(x)
    integer = dt.kind == "i"
    scale = float(-np.iinfo(dt).min) if integer else 1.0
    xf = (x.astype(np.float64) / scale) if integer else x

    mono = xf.ndim == 1
    frames = xf[:, None] if mono else xf
    # channels ride the stream axis of one one-shot call (the native
    # batched path), not a Python loop.
    plan = plan_engine(float(in_rate), float(out_rate),
                       preset_to_engine_quality(preset))
    comp = _compute_dtype(dt, device)
    y = _engine_oneshot(plan, np.ascontiguousarray(frames.T, dtype=comp),
                        dtype=comp, device=device).cpu().numpy().T

    if integer:
        y = np.clip(np.round(y * scale), np.iinfo(dt).min,
                    np.iinfo(dt).max).astype(dt)
    else:
        y = y.astype(dt)
    return y[:, 0] if mono else y


class ResampleStream:
    """Streaming resampler, python-soxr signature.

    ``resample_chunk(x, last=False)`` consumes a frame-major chunk and
    returns the available output; ``last=True`` flushes the tail.  The
    concatenated chunked output equals the one-shot ``resample`` for the
    same total input (chunking invariance, processinto_test.go:562
    analog).
    """

    def __init__(self, in_rate: float, out_rate: float, num_channels: int,
                 dtype="float32", quality="HQ", device='cuda'):
        if num_channels < 1:
            raise ValueError("num_channels must be >= 1")
        self._dtype = np.dtype(dtype)
        if self._dtype.kind not in "fi":
            raise TypeError(f"unsupported dtype {dtype}")
        self._scale = (float(-np.iinfo(self._dtype).min)
                       if self._dtype.kind == "i" else 1.0)
        if self._dtype.kind == "i" and self._dtype not in (
                np.dtype(np.int16), np.dtype(np.int32)):
            raise TypeError(f"unsupported dtype {dtype}")
        comp = _compute_dtype(self._dtype, device)
        self._channels = num_channels
        # All channels ride the stream axis of ONE direct engine (the
        # reference's per-channel goroutines, SURVEY.md section 2); the
        # direct path also makes chunked output bit-equal to resample().
        plan = plan_engine(float(in_rate), float(out_rate),
                           preset_to_engine_quality(_preset(quality)))
        self._eng = EngineCore(plan, batch=num_channels, dtype=comp,
                               device=device)
        self._comp = comp
        self._done = False

    def resample_chunk(self, x, last: bool = False) -> np.ndarray:
        if self._done:
            raise RuntimeError("stream already flushed (last=True was sent)")
        x = np.asarray(x)
        if self._channels > 1:
            if x.ndim != 2 or x.shape[1] != self._channels:
                raise ValueError(f"expected [n, {self._channels}] chunk, "
                                 f"got shape {x.shape}")
        elif x.ndim == 2 and x.shape[1] == 1:
            x = x[:, 0]                     # mono accepts [n, 1] like [n]
        elif x.ndim != 1:
            raise ValueError(f"expected [n] chunk, got shape {x.shape}")
        xf = x.astype(np.float64) / self._scale if self._scale != 1.0 else x
        frames = xf[:, None] if xf.ndim == 1 else xf
        stream = np.ascontiguousarray(frames.T, dtype=self._comp)
        y = (self._eng.process(stream) if stream.shape[1]
             else np.zeros((self._channels, 0), self._comp))
        if last:
            y = np.concatenate([y, self._eng.flush()], axis=1)
            self._done = True
        y = y.T
        if self._scale != 1.0:
            y = np.clip(np.round(y * self._scale), np.iinfo(self._dtype).min,
                        np.iinfo(self._dtype).max)
        y = y.astype(self._dtype)
        return y[:, 0] if self._channels == 1 else y

    def num_channels(self) -> int:
        return self._channels

    def clear(self) -> None:
        """Reset stream state (python-soxr ``clear``)."""
        self._eng.reset()
        self._done = False
