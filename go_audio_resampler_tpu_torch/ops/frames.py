"""Framing helpers of the kernels' plain versions.

The JAX package's ``gather_windows`` comes in two forms here: the fused
banded kernels' plain versions read their frames at a fixed stride, which
is a strided ``unfold`` view that copies nothing (``gather_windows``),
while the per-tile kernel's plain version reads windows at arbitrary
starts through the clipped gather (``gather_windows_at``).
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


def gather_windows_at(signal: torch.Tensor, starts: torch.Tensor,
                      width: int) -> torch.Tensor:
    """windows[s, c, t] = signal[s, starts[c] + t]  (clipped gather).

    Indices past either end of ``signal`` read its first or last sample,
    as the JAX package's ``gather_windows`` does.  Returns a copy
    [S, len(starts), width].
    """
    idx = (starts.to(device=signal.device, dtype=torch.int64)[:, None]
           + torch.arange(width, device=signal.device)[None, :])
    return signal[:, idx.clamp(0, signal.shape[1] - 1)]
