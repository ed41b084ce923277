"""PyTorch/CUDA port of go_audio_resampler_tpu.

Mirrors the JAX package's module layout; the JAX package stays the
reference and this package imports none of it.  This slice carries the
streaming engine for exact-rational two-stage plans (44.1k <-> 48k) with
its fused banded-resample CUDA kernel (``ops/csrc/fused_resample.cu``).
"""

from .engine import EngineCore, plan_engine
from .filterdesign import Quality

__version__ = "0.1.0"

__all__ = ["EngineCore", "plan_engine", "Quality"]
