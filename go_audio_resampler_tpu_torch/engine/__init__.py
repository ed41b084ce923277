"""Engine: topology planning, banded-operator builders, one-shot and
streaming execution.

As in the JAX package, the function ``oneshot`` is exported under its
module's name: import the module itself with
``importlib.import_module("go_audio_resampler_tpu_torch.engine.oneshot")``.
"""

from .plan import (EnginePlan, EngineConfigError, plan_engine,
                   plan_from_arrays, MIN_RATIO, MAX_RATIO)
from .counts import LengthModel
from .oneshot import oneshot
from .streaming import EngineCore
from .checkpoint import (save_stream_state, load_stream_state,
                         save_resampler_state, load_resampler_state,
                         save_vr_state, load_vr_state)
from .variable import VariableRateResampler
from .fftstage import fft_oneshot
from .tmajor import TimeMajorEngine

__all__ = [
    "EnginePlan", "EngineConfigError", "plan_engine", "plan_from_arrays",
    "MIN_RATIO", "MAX_RATIO", "LengthModel", "oneshot", "EngineCore",
    "save_stream_state", "load_stream_state", "save_resampler_state",
    "load_resampler_state", "save_vr_state", "load_vr_state",
    "VariableRateResampler", "fft_oneshot", "TimeMajorEngine",
]
