"""Batched 1-D FIR convolution: the banded lowering (K1), the frames
lowering and the xla lowering.

Counterpart of the JAX package's ``ops/convolve.py``: one primitive
``conv1d_poly(x, kernels, stride)`` computing

    y[s, f, i] = sum_t x[s, i*stride + t] * kernels[f, t]

and its interleaved form for the polyphase upsampler.  Three lowerings:

- ``banded``: P outputs per frame read a shared (P-1)*stride + T window
  against a banded [W, P*F] matrix (``band_matrix``), which is exactly the
  fused-resampling structure, so on the card it is one launch of the K1
  kernel (``ops/fused.py``) with P = 128, as the JAX package's TPU path
  runs its Pallas kernel (inside ``precision.force_xla``, K1's plain
  version instead).  CUDA tensors take it.
- ``frames``: windows as an ``unfold`` view, then one ``einsum``.  CPU
  tensors take it, as the JAX package does on its CPU backend.
- ``xla``: ``torch.nn.functional.conv1d`` with the kernels as [F, 1, T]
  weights (the JAX package's ``lax.conv_general_dilated``), never chosen
  by default.

By default the tensor's device picks the lowering; :func:`set_conv_impl`
forces one for the whole process, as the JAX package's does.

``precision`` is the matmul tier of every lowering (one of
``precision.PRECISION_MODES``; 'auto' reads the process-wide tier), which
the two entry points resolve once: the banded lowering's operator is
prepared at it, the frames and xla lowerings form their products with
``precision.tiered_matmul``.  The helpers below them take the resolved
tier.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import banded, fused
from .precision import (PRECISION_MODES, check_tier, dispatch_allowed,
                        dot_precision, tiered_matmul)

#: outputs per frame of the banded lowering on the card
BAND_PERIOD = 128
_IMPL_OVERRIDE: str | None = None


def set_conv_impl(impl: str | None) -> None:
    """Force a lowering of :func:`conv1d_poly` and
    :func:`conv1d_poly_interleaved` for the whole process: 'xla'
    (``F.conv1d``), 'frames', 'banded' (K1 on a CUDA tensor, its plain
    version on the CPU), or None (the default: banded on a CUDA tensor,
    frames on the CPU).  A choice made by hand, as ``dispatch='xla'``
    is, not a fallback."""
    global _IMPL_OVERRIDE
    if impl not in (None, 'xla', 'frames', 'banded'):
        raise ValueError(f"unknown conv impl: {impl}")
    _IMPL_OVERRIDE = impl


def _impl(x: torch.Tensor) -> str:
    if _IMPL_OVERRIDE is not None:
        return _IMPL_OVERRIDE
    return 'banded' if x.device.type == 'cuda' else 'frames'


def _tier(precision: str) -> str:
    """The tier of ``precision``, one of PRECISION_MODES."""
    if precision not in PRECISION_MODES:
        raise ValueError(f"precision must be one of {PRECISION_MODES}, got "
                         f"{precision!r}")
    return dot_precision(precision)


def band_matrix(kernels: torch.Tensor, p: int, stride: int,
                dtype: torch.dtype, device) -> tuple[torch.Tensor, int]:
    """R_t [W, p*F] with R_t[ii*stride + tau, ii*F + ff] = kernels[ff, tau].

    W = (p-1)*stride + T.  Every (row, column) pair is set at most once,
    so the matrix holds the kernels' values exactly.
    """
    f, t = kernels.shape
    w = (p - 1) * stride + t
    ii = torch.arange(p, device=device).repeat_interleave(f * t)
    ff = torch.arange(f, device=device).repeat_interleave(t).repeat(p)
    tau = torch.arange(t, device=device).repeat(p * f)
    r = torch.zeros((w, p * f), dtype=dtype, device=device)
    r[ii * stride + tau, ii * f + ff] = kernels.to(device=device,
                                                   dtype=dtype)[ff, tau]
    return r, w


class ConvBand(NamedTuple):
    """The banded lowering's operator for inputs of one length: R_t
    [W, p*F] (``band_matrix``), its period p, and on the card R_t as K1
    reads it at the call's tier (``banded.prepare``; None elsewhere)."""
    r_t: torch.Tensor
    p: int
    op: banded.BandedOperator | None


def _band_period(n: int, t: int, stride: int) -> int:
    """Outputs per frame of the banded lowering of an n-sample input."""
    return min(BAND_PERIOD, max((n - t) // stride + 1, 1))


def band_operator(kernels: torch.Tensor, n: int, stride: int,
                  dtype: torch.dtype, device, tier: str) -> ConvBand:
    """The banded lowering's operator for n-sample inputs at the resolved
    ``tier``,
    built and prepared once; callers that apply one convolution to many
    inputs of a length (the one-shot DFT prestage) build it ahead and pass
    it as ``band``."""
    p = _band_period(n, kernels.shape[1], stride)
    r_t, _ = band_matrix(kernels, p, stride, dtype, device)
    return ConvBand(r_t, p, banded.prepare_on_card(r_t, tier))


def _conv_frames(x: torch.Tensor, kernels: torch.Tensor, stride: int,
                 tier: str) -> torch.Tensor:
    """Frames lowering: [S, n] -> [S, F, n_out], at ``tier``."""
    t = kernels.shape[1]
    windows = x.unfold(1, t, stride)                     # [S, n_out, T]
    return tiered_matmul(windows, kernels.to(x.dtype), tier,
                         lambda a, b: torch.einsum('sct,ft->sfc', a, b))


@contextlib.contextmanager
def _cudnn_without_tf32():
    """cuDNN's float32 convolutions at float32 accuracy (its default is
    TF32), the old setting restored after."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _conv_xla(x: torch.Tensor, kernels: torch.Tensor, stride: int,
              tier: str) -> torch.Tensor:
    """xla lowering: ``F.conv1d`` of [S, 1, n] with [F, 1, T] weights at
    ``stride`` -> [S, F, n_out], at ``tier`` (float32 products on the
    card, cuDNN's TF32 off)."""
    def conv(a, b):
        return F.conv1d(a, b, stride=stride)
    with _cudnn_without_tf32():
        return tiered_matmul(x[:, None, :], kernels[:, None, :].to(x.dtype),
                             tier, conv)


def _conv_banded(x: torch.Tensor, kernels: torch.Tensor, stride: int,
                 interleaved: bool = False, band: ConvBand | None = None, *,
                 tier: str) -> torch.Tensor:
    """Banded lowering (see the module docstring): one K1 call at the
    resolved ``tier``.

    With ``interleaved`` the result is the flat [S, n_out*F] stream
    y[s, i*F + ff] (the polyphase-upsampling order), the band's natural
    output layout.  ``band`` is :func:`band_operator` for this input's
    length and tier; without it the call builds it.
    """
    s, n = x.shape
    f, t = kernels.shape
    n_out = (n - t) // stride + 1
    check_tier(tier)
    if band is None:
        band = band_operator(kernels, n, stride, x.dtype, x.device, tier)
    p = band.p
    if p != _band_period(n, t, stride):
        raise ValueError(f"_conv_banded: band was built for period {p}, "
                         f"the {n}-sample input takes "
                         f"{_band_period(n, t, stride)}")
    nf = -(-n_out // p)
    ipx, p2 = p * stride, p * f
    w = band.r_t.shape[0]
    need = (nf - 1) * ipx + w
    if n < need:
        x = torch.cat([x, x.new_zeros((s, need - n))], dim=1)
    kw = dict(ipx=ipx, wx=w, p2=p2, n_frames=nf, tier=tier)
    if dispatch_allowed(tier):
        y3 = fused.fused_resample(x.contiguous(), band.r_t, op=band.op, **kw)
    else:
        y3 = fused.fused_resample_reference(x, band.r_t, **kw)
    # y3: [S, nf*p*F]
    if interleaved:
        # y3[s, k*p*F + ii*F + ff] = filter ff at output k*p + ii: already
        # the polyphase-interleaved order.
        return y3[:, :n_out * f]
    y = y3.reshape(s, nf, p, f).permute(0, 3, 1, 2).reshape(s, f, nf * p)
    return y[:, :, :n_out]


def conv1d_poly(x: torch.Tensor, kernels: torch.Tensor, stride: int = 1,
                precision: str = 'auto',
                band: ConvBand | None = None) -> torch.Tensor:
    """y[s, f, i] = sum_t x[s, i*stride + t] * kernels[f, t]  ('VALID').

    ``kernels`` rows are tap-reversed filters (design-time convention), so
    this correlation implements the reference's convolution direction.
    The K1 kernel on a CUDA tensor (reading ``band`` where given,
    prepared at the tier of ``precision``), the frames lowering on a CPU
    tensor, at the tier of ``precision``; :func:`set_conv_impl` forces
    another (``band`` is read only by the banded lowering).
    """
    tier = _tier(precision)
    impl = _impl(x)
    if impl == 'xla':
        return _conv_xla(x, kernels, stride, tier)
    if impl == 'banded':
        return _conv_banded(x, kernels, stride, band=band, tier=tier)
    return _conv_frames(x, kernels, stride, tier)


def conv1d_poly_interleaved(x: torch.Tensor, kernels: torch.Tensor,
                            precision: str = 'auto',
                            band: ConvBand | None = None) -> torch.Tensor:
    """u[s, i*F + ff] = sum_t x[s, i + t] * kernels[ff, t] (stride 1).

    The polyphase-upsampled stream in its natural interleaved order.  The
    banded lowering emits this layout directly (on the card, reading
    ``band`` where given, prepared at the tier of ``precision``); the
    frames and xla lowerings transpose their [S, F, n_out] output.
    """
    if _impl(x) == 'banded':
        return _conv_banded(x, kernels, 1, interleaved=True, band=band,
                            tier=_tier(precision))
    out = conv1d_poly(x, kernels, 1, precision)          # [S, F, n_out]
    return out.transpose(1, 2).reshape(x.shape[0], -1)
