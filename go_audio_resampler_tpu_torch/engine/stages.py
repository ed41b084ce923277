"""Framing helpers for the banded steps.

Only ``gather_windows`` is ported so far: the fused exact-rational step
reads its frames at a fixed stride, so the JAX package's clipped gather
becomes a strided ``unfold`` view, which copies nothing.
"""

from __future__ import annotations

import torch


def gather_windows(signal: torch.Tensor, n_windows: int, stride: int,
                   width: int) -> torch.Tensor:
    """windows[s, c, t] = signal[s, c*stride + t] for c < n_windows.

    Returns a view [S, n_windows, width].  Unlike the JAX package's
    clipped gather, the windows must lie inside ``signal``:
    ``signal.shape[1] >= (n_windows - 1) * stride + width``.
    """
    need = (n_windows - 1) * stride + width
    if n_windows < 1 or signal.shape[1] < need:
        raise ValueError(
            f"gather_windows: {n_windows} windows of width {width} at "
            f"stride {stride} need {need} samples, got {signal.shape[1]}")
    return signal[:, :need].unfold(1, width, stride)
