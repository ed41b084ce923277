"""Convenience API: direct-engine wrappers, one-shots, interleave helpers.

PyTorch counterpart of the JAX package's ``convenience.py``, the
reference's convenience.go:

- rate constants                    <-> convenience.go:11-41
- ``new_cd_to_dat`` etc.            <-> convenience.go:43-113
- ``SimpleResampler`` (float64)     <-> convenience.go:115-200
- ``SimpleResamplerFloat32``        <-> convenience.go:296-395
- ``resample_mono`` / ``_stereo``   <-> convenience.go:202-257, 397-457
- interleave/deinterleave helpers   <-> convenience.go:259-282, 459-486

The direct-engine path bypasses the pipeline planner (the path the
reference CLI uses, helpers.go:77-91); the one-shot helpers run the
engine's one-shot (``engine/oneshot.py``: one K1 or K3 launch on the
card).

Every entry point takes ``device`` ('cuda' by default; 'cpu' runs the
kernels' plain versions).  The float64 entry points compute at
``api.default_dtype`` of the device — float32 on the card, as the JAX
package computes on a TPU, float64 on the CPU — and return float64
arrays.
"""

from __future__ import annotations

import numpy as np

from .api import (Config, QualityPreset, QualitySpec, BufferTooSmallError,
                  new_resampler, default_dtype, ESTIMATE_OUTPUT_MARGIN)
from .engine import EngineCore, plan_engine, oneshot
from .filterdesign import Quality as EngineQuality

# Common sample rates (convenience.go:11-41)
RATE_CD = 44100
RATE_DAT = 48000
RATE_HIRES_88 = 88200
RATE_HIRES_96 = 96000
RATE_HIRES_176 = 176400
RATE_HIRES_192 = 192000
RATE_TELEPHONY = 8000
RATE_VOIP = 16000
RATE_SPEECH = 22050
RATE_VIDEO = 48000


def _new(input_rate, output_rate, channels, quality, device):
    return new_resampler(Config(input_rate, output_rate, channels=channels,
                                quality=QualitySpec(preset=quality),
                                device=device))


def new_cd_to_dat(quality: QualityPreset = QualityPreset.HIGH,
                  device='cuda'):
    """CD (44.1k) -> DAT (48k) pipeline resampler (convenience.go:43-52)."""
    return _new(RATE_CD, RATE_DAT, 1, quality, device)


def new_dat_to_cd(quality: QualityPreset = QualityPreset.HIGH,
                  device='cuda'):
    return _new(RATE_DAT, RATE_CD, 1, quality, device)


def new_cd_to_hires(quality: QualityPreset = QualityPreset.HIGH,
                    device='cuda'):
    return _new(RATE_CD, RATE_HIRES_88, 1, quality, device)


def new_hires_to_cd(quality: QualityPreset = QualityPreset.HIGH,
                    device='cuda'):
    return _new(RATE_HIRES_88, RATE_CD, 1, quality, device)


def new_simple(input_rate: float, output_rate: float, device='cuda'):
    """Mono pipeline resampler at QualityHigh (convenience.go:84-93)."""
    return _new(input_rate, output_rate, 1, QualityPreset.HIGH, device)


def new_stereo(input_rate: float, output_rate: float,
               quality: QualityPreset = QualityPreset.HIGH, device='cuda'):
    return _new(input_rate, output_rate, 2, quality, device)


def new_multi_channel(input_rate: float, output_rate: float, channels: int,
                      quality: QualityPreset = QualityPreset.HIGH,
                      device='cuda'):
    return _new(input_rate, output_rate, channels, quality, device)


def preset_to_engine_quality(preset: QualityPreset) -> EngineQuality:
    """Preset -> engine quality for the direct path (convenience.go:189-200)."""
    preset = QualityPreset(preset)
    if preset in (QualityPreset.QUICK, QualityPreset.LOW):
        return EngineQuality.LOW
    if preset == QualityPreset.MEDIUM:
        return EngineQuality.MEDIUM
    if preset in (QualityPreset.HIGH, QualityPreset.VERY_HIGH):
        return EngineQuality.HIGH
    return EngineQuality.MEDIUM


def _compute_dtype(declared, device):
    """The dtype an entry point declaring ``declared`` computes in on
    ``device``: float32 on the card whatever is declared."""
    return np.float32 if default_dtype(device) == np.float32 else declared


class _SimpleBase:
    """Shared direct-engine wrapper (streaming EngineCore, batch=1).

    ``_dtype`` is the declared dtype of inputs and outputs; the engine
    computes in it on the CPU and in float32 on the card."""

    _dtype = np.float64

    def __init__(self, input_rate: float, output_rate: float,
                 quality: QualityPreset, block: int = 2048, batch: int = 1,
                 strict_antialias: bool = False, dispatch: str = 'auto',
                 precision: str = 'auto', hq_interp: bool = False,
                 device='cuda'):
        engine_quality = preset_to_engine_quality(quality)
        self.plan = plan_engine(float(input_rate), float(output_rate),
                                engine_quality, strict_antialias, hq_interp)
        self.engine = EngineCore(self.plan, batch=batch, block=block,
                                 dtype=_compute_dtype(self._dtype, device),
                                 dispatch=dispatch, precision=precision,
                                 device=device)
        self._out_queue = np.zeros(0, dtype=self._dtype)

    def _take(self, fresh: np.ndarray, limit: int | None) -> np.ndarray:
        """Prepend queued output; hold back anything beyond ``limit``.

        The engine drains whole blocks, so a small call can release more
        output than estimate_output(len(x)); queuing the excess keeps the
        reference's contract that a buffer of estimate_output(n) samples
        is always enough (convenience.go:139-166)."""
        avail = np.concatenate([self._out_queue,
                                fresh.astype(self._dtype, copy=False)])
        if limit is None or len(avail) <= limit:
            self._out_queue = np.zeros(0, dtype=self._dtype)
            return avail
        self._out_queue = avail[limit:]
        return avail[:limit]

    def process(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=self._dtype)
        y = self.engine.process(x[None, :] if x.ndim == 1 else x)[0]
        return self._take(y, None)

    def process_into(self, x, out: np.ndarray) -> int:
        """Resample into a caller buffer; BufferTooSmallError before any
        state advance (convenience.go:139-160).  A buffer of
        estimate_output(len(x)) samples is always sufficient; any output
        the engine releases beyond it is queued for the next call."""
        x = np.asarray(x, dtype=self._dtype)
        required = self.estimate_output(len(x))
        if out.shape[-1] < required:
            raise BufferTooSmallError(
                f"output buffer {out.shape[-1]} < required {required}")
        y = self._take(self.engine.process(x[None, :])[0],
                       int(out.shape[-1]))
        out[..., :len(y)] = y
        return len(y)

    def estimate_output(self, n_in: int) -> int:
        """floor(n*ratio) + 64 upper bound (convenience.go:162-166)."""
        return int(n_in * self.plan.ratio) + ESTIMATE_OUTPUT_MARGIN

    def flush(self) -> np.ndarray:
        return self._take(self.engine.flush()[0], None)

    def reset(self) -> None:
        self.engine.reset()
        self._out_queue = np.zeros(0, dtype=self._dtype)

    def get_ratio(self) -> float:
        return self.plan.ratio

    def get_statistics(self) -> dict:
        return self.engine.get_statistics()


class SimpleResampler(_SimpleBase):
    """float64 direct-engine resampler (convenience.go:115-186); computes
    in float32 on the card."""

    _dtype = np.float64


class SimpleResamplerFloat32(_SimpleBase):
    """float32-native direct-engine resampler (convenience.go:296-395).

    On the card this is the performance path: the whole pipeline stays
    float32.
    """

    _dtype = np.float32


def new_engine(input_rate: float, output_rate: float,
               quality: QualityPreset = QualityPreset.HIGH,
               hq_interp: bool = False, device='cuda') -> SimpleResampler:
    """Direct-engine float64 resampler (NewEngine, convenience.go:122-132).

    ``hq_interp`` (beyond reference, non-exact ratios only): corrected
    phase-bank boundary + 8x denser banks — see api.Config.hq_interp.
    """
    return SimpleResampler(input_rate, output_rate, quality,
                           hq_interp=hq_interp, device=device)


def new_engine_float32(input_rate: float, output_rate: float,
                       quality: QualityPreset = QualityPreset.HIGH,
                       hq_interp: bool = False,
                       device='cuda') -> SimpleResamplerFloat32:
    """Direct-engine float32 resampler (convenience.go:319-336)."""
    return SimpleResamplerFloat32(input_rate, output_rate, quality,
                                  hq_interp=hq_interp, device=device)


def new_variable_rate(input_rate: float, max_output_rate: float, *,
                      output_rate: float | None = None, channels: int = 1,
                      dtype=np.float32, hq: bool = False, device='cuda'):
    """Variable-rate resampler (libsoxr SOXR_VR; beyond the Go reference).

    ``max_output_rate`` bounds how high the output rate may ever be set
    (sizes device buffers, soxr-style).  The initial rate defaults to
    ``max_output_rate``; change it at runtime with
    ``set_io_ratio(input_rate / new_output_rate, slew_len)``.
    """
    from .engine.variable import VariableRateResampler

    init_out = output_rate if output_rate is not None else max_output_rate
    return VariableRateResampler(
        max_output_rate / input_rate, input_rate / init_out,
        batch=channels, dtype=dtype, quality='vr-hq' if hq else 'vr',
        device=device)


# --- one-shot helpers -------------------------------------------------------

def _oneshot_rows(rows, input_rate, output_rate, quality, dtype,
                  device) -> np.ndarray:
    """``rows`` [S, n] through the one-shot of the direct-engine plan;
    returned in the declared ``dtype``."""
    plan = plan_engine(float(input_rate), float(output_rate),
                       preset_to_engine_quality(quality))
    x = np.asarray(rows, dtype=dtype)
    y = oneshot(plan, x, dtype=_compute_dtype(dtype, device), device=device)
    return y.cpu().numpy().astype(dtype, copy=False)


def resample_mono(x, input_rate: float, output_rate: float,
                  quality: QualityPreset = QualityPreset.HIGH,
                  device='cuda') -> np.ndarray:
    """One-shot mono resample = Process + Flush (convenience.go:202-229).

    One one-shot call (one kernel launch on the card, computing in
    float32 there); returns float64.
    """
    x = np.asarray(x, dtype=np.float64)
    return _oneshot_rows(x[None, :], input_rate, output_rate, quality,
                         np.float64, device)[0]


def _stereo(left, right, input_rate, output_rate, quality, dtype, device):
    l = np.asarray(left, dtype=dtype)
    r = np.asarray(right, dtype=dtype)
    if len(l) != len(r):
        # process independently (reference supports unequal lengths)
        return tuple(_oneshot_rows(c[None, :], input_rate, output_rate,
                                   quality, dtype, device)[0] for c in (l, r))
    y = _oneshot_rows(np.stack([l, r]), input_rate, output_rate, quality,
                      dtype, device)
    return y[0], y[1]


def resample_stereo(left, right, input_rate: float, output_rate: float,
                    quality: QualityPreset = QualityPreset.HIGH,
                    device='cuda'):
    """One-shot stereo resample; both channels ride the batch axis of one
    call (convenience.go:231-257's engine reuse, without the serial Reset
    dance — channels are independent lanes)."""
    return _stereo(left, right, input_rate, output_rate, quality,
                   np.float64, device)


def resample_mono_float32(x, input_rate: float, output_rate: float,
                          quality: QualityPreset = QualityPreset.HIGH,
                          device='cuda') -> np.ndarray:
    """float32 one-shot mono resample (convenience.go:397-414)."""
    x = np.asarray(x, dtype=np.float32)
    return _oneshot_rows(x[None, :], input_rate, output_rate, quality,
                         np.float32, device)[0]


def resample_stereo_float32(left, right, input_rate: float, output_rate: float,
                            quality: QualityPreset = QualityPreset.HIGH,
                            device='cuda'):
    """float32 one-shot stereo resample (convenience.go:431-457)."""
    return _stereo(left, right, input_rate, output_rate, quality,
                   np.float32, device)


# --- interleave helpers (convenience.go:259-282, 459-486) -------------------

def interleave_to_stereo(left, right) -> np.ndarray:
    """[L0, R0, L1, R1, ...] from two mono channels."""
    left = np.asarray(left)
    right = np.asarray(right)
    n = min(len(left), len(right))
    out = np.empty(2 * n, dtype=np.result_type(left, right))
    out[0::2] = left[:n]
    out[1::2] = right[:n]
    return out


def deinterleave_from_stereo(interleaved):
    """Two mono channels from [L0, R0, L1, R1, ...]."""
    x = np.asarray(interleaved)
    n = len(x) // 2
    return x[: 2 * n : 2].copy(), x[1: 2 * n : 2].copy()


# float32 aliases for API parity (the numpy versions are dtype-generic)
interleave_to_stereo_float32 = interleave_to_stereo
deinterleave_from_stereo_float32 = deinterleave_from_stereo
