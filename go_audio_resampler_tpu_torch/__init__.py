"""PyTorch/CUDA port of go_audio_resampler_tpu.

Mirrors the JAX package's module layout and public API; the JAX package
stays the reference and this package imports none of it.  The public API
(``api``: ``Config``, ``Resampler``, ``new_resampler``; ``convenience``:
the direct engines, the one-shot helpers) runs on the streaming engine
for exact-rational plans (with or without the strict-antialias
prefilter), integer decimation, banded composites of a stage chain
(``pipeline.fuse_chain``), the general walk of non-exact ratios (and its
prefilter), cubic plans and integer upsampling, on the time-major twin of
its fused banded steps, and on the one-shot entry point, through three
hand-written CUDA kernels (``ops/csrc/*.cu``); long prefilters and
decimation filters past their crossovers run by FFT overlap-save
(``engine/fftstage.py``, ``torch.fft``).  Beside them: the variable-rate
resampler (``VariableRateResampler``, ``new_variable_rate``), checkpoint
and resume of live streams (``engine.checkpoint``, in the JAX package's
file format), the differentiable ``functional.resample``, the
python-soxr and torchaudio shims (``soxr_compat``, ``torch_compat``);
stream sharding over ``torch.distributed`` (the subpackage ``parallel``:
a ``DeviceMesh`` of one rank a card, ``DTensor`` outputs), the command-
line tools (``cli``: ``resample_wav`` with WAV I/O from ``utils.wav``,
``resample_info``, ``analyze_filter``), the Hopper roofline
(``utils.roofline``) and the quality record of the card's output
(``tools.quality_cuda``), and the lowering selection: the engines'
``dispatch='tune'`` (timed on CUDA graphs), ``EngineCore.core_fn`` and
``ops.set_conv_impl``.

Every entry point runs on the card (``device='cuda'``) unless the caller
passes ``device='cpu'``.
"""

from .api import (
    Config,
    QualityPreset,
    QualitySpec,
    QualityFlags,
    Info,
    Resampler,
    ResamplerError,
    InvalidConfigError,
    BufferTooSmallError,
    NotSupportedError,
    new_resampler,
    get_preset_spec,
    get_info,
    precision_to_engine_quality,
    MAX_CHANNELS,
    ESTIMATE_OUTPUT_MARGIN,
)
from .convenience import (
    RATE_CD, RATE_DAT, RATE_HIRES_88, RATE_HIRES_96, RATE_HIRES_176,
    RATE_HIRES_192, RATE_TELEPHONY, RATE_VOIP, RATE_SPEECH, RATE_VIDEO,
    SimpleResampler,
    SimpleResamplerFloat32,
    new_engine,
    new_engine_float32,
    new_variable_rate,
    new_cd_to_dat,
    new_dat_to_cd,
    new_cd_to_hires,
    new_hires_to_cd,
    new_simple,
    new_stereo,
    new_multi_channel,
    preset_to_engine_quality,
    resample_mono,
    resample_stereo,
    resample_mono_float32,
    resample_stereo_float32,
    interleave_to_stereo,
    deinterleave_from_stereo,
    interleave_to_stereo_float32,
    deinterleave_from_stereo_float32,
)
from .engine import (EngineCore, TimeMajorEngine, VariableRateResampler,
                     oneshot, plan_engine)
from .filterdesign import Quality, Quality as EngineQuality
from . import functional
from .functional import resample

__version__ = "0.1.0"

__all__ = [
    "Config", "QualityPreset", "QualitySpec", "QualityFlags", "Info",
    "Resampler", "ResamplerError", "InvalidConfigError",
    "BufferTooSmallError", "NotSupportedError", "new_resampler",
    "get_preset_spec", "get_info", "precision_to_engine_quality",
    "MAX_CHANNELS", "ESTIMATE_OUTPUT_MARGIN",
    "RATE_CD", "RATE_DAT", "RATE_HIRES_88", "RATE_HIRES_96",
    "RATE_HIRES_176", "RATE_HIRES_192", "RATE_TELEPHONY", "RATE_VOIP",
    "RATE_SPEECH", "RATE_VIDEO",
    "SimpleResampler", "SimpleResamplerFloat32", "new_engine",
    "new_engine_float32", "new_variable_rate", "new_cd_to_dat", "new_dat_to_cd",
    "new_cd_to_hires", "new_hires_to_cd", "new_simple", "new_stereo",
    "new_multi_channel", "preset_to_engine_quality", "resample_mono",
    "resample_stereo", "resample_mono_float32", "resample_stereo_float32",
    "interleave_to_stereo", "deinterleave_from_stereo",
    "interleave_to_stereo_float32", "deinterleave_from_stereo_float32",
    "EngineCore", "TimeMajorEngine", "plan_engine", "oneshot",
    "EngineQuality", "Quality", "VariableRateResampler", "functional",
    "resample",
]
