"""Utilities: test-signal synthesis, DSP quality metrics (numpy), WAV I/O
(``wav``) and the Hopper roofline (``roofline``)."""

from . import metrics, signals

__all__ = ["metrics", "signals"]
