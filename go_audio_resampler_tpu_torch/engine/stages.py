"""Framing helpers and the prestage of the banded paths.

The framing helpers live with the kernels whose plain versions use them
(``ops/frames.py``) and are re-exported here, where the JAX package keeps
its ``gather_windows``.  ``prestage_apply`` is the integer-factor
polyphase upsampler of the one-shot DFT topology.
"""

from __future__ import annotations

import torch

from ..ops.convolve import ConvBand, conv1d_poly_interleaved
from ..ops.frames import gather_windows, gather_windows_at

__all__ = ["gather_windows", "gather_windows_at", "prestage_apply"]


def prestage_apply(coeffs: torch.Tensor, xext: torch.Tensor, factor: int,
                   precision: str = 'auto',
                   band: ConvBand | None = None) -> torch.Tensor:
    """u[s, i*F + p] = dot(xext[s, i:i+T1], coeffs[p]) for all valid i.

    ``coeffs`` [F, T1] are tap-reversed (design time), so this correlation
    is the reference's polyphase convolution.  On the card it is the K1
    kernel through the banded lowering of ``ops/convolve.py``, reading
    ``band`` (``band_operator`` for xext's length, at the tier) where
    given.  ``precision`` is the matmul tier, one of
    ``ops.precision.PRECISION_MODES``.
    """
    del factor  # implied by coeffs.shape[0]
    return conv1d_poly_interleaved(xext, coeffs, precision, band=band)
