"""Utilities: test-signal synthesis and DSP quality metrics (numpy)."""

from . import metrics, signals

__all__ = ["metrics", "signals"]
