"""PyTorch/CUDA port of go_audio_resampler_tpu.

Mirrors the JAX package's module layout; the JAX package stays the
reference and this package imports none of it.  It carries the streaming
engine for exact-rational two-stage plans (44.1k <-> 48k, with or without
the strict-antialias prefilter), integer decimation, banded composites of
a stage chain (``pipeline.fuse_chain``), the general walk of non-exact
ratios (and its prefilter), cubic plans and integer upsampling, the
time-major twin of its fused banded steps, and the one-shot entry point,
on three hand-written CUDA kernels (``ops/csrc/*.cu``).
"""

from .engine import EngineCore, TimeMajorEngine, oneshot, plan_engine
from .filterdesign import Quality

__version__ = "0.1.0"

__all__ = ["EngineCore", "TimeMajorEngine", "oneshot", "plan_engine",
           "Quality"]
