"""FFT overlap-save for the long-FIR stages.

Counterpart of the JAX package's ``engine/fftstage.py``: block-FFT
(overlap-save) evaluation of the integer-decimation and DFT-upsample
stages, and of the strict-antialias prefilter of a non-exact plan, exact
to their time-domain definitions:

- decimate:  y[j] = sum_t xs[j*M + t] * c[t]
- dft_up:    u[i*F + p] = sum_tau xext[i+tau] * coeffs[p][tau], sliced
             [drop : drop+canonical]

The overlap-save core computes the full correlation stream
``f[i] = sum_t xs[i+t] h[t]`` in hops of ``L = N - T + 1`` valid outputs
per N-point real FFT (``torch.fft``: cuFFT on the card, pocketfft on the
CPU; complex64 for float32, complex128 for float64).  The filter's
spectrum ``H`` is computed on the host in float64 and uploaded once per
filter, dtype and device (:func:`spectrum`): an engine does it when it is
built, the one-shot once per call.

These routes have no hand-written kernel: the JAX package runs them as
``jnp.fft`` outside any Pallas kernel, and here they are ``torch.fft``.
Which taps take them is decided by ``oneshot.FFT_CONV_MIN_TAPS`` (the
prefilter) and ``oneshot.DECIM_FFT_MIN_TAPS`` (decimation).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .plan import EnginePlan


class Spectrum(NamedTuple):
    """A filter's overlap-save spectrum on a device: ``H`` [N//2+1]
    (complex64 or complex128), the filter's ``taps`` and the FFT size
    ``n``."""
    H: torch.Tensor
    taps: int
    n: int


def _fft_len(t: int) -> int:
    """FFT size: next power of two giving a hop of at least ~3x taps."""
    n = 1
    while n < 4 * t or n < 4096:
        n *= 2
    return n


def spectrum(h, dtype: torch.dtype, device) -> Spectrum:
    """The overlap-save spectrum of the correlation taps ``h`` (host,
    float64) for ``dtype`` inputs on ``device``.

    Correlation with h is convolution with reverse(h); its N-point rfft
    is computed in float64 on the host and rounded once to the complex
    type of ``dtype``, as the JAX package's trace-time constant is.
    """
    h = np.asarray(h, dtype=np.float64)
    t = len(h)
    n = _fft_len(t)
    hrev = np.zeros(n, dtype=np.float64)
    hrev[:t] = h[::-1]
    cplx = torch.complex128 if dtype == torch.float64 else torch.complex64
    return Spectrum(torch.as_tensor(np.fft.rfft(hrev), dtype=cplx,
                                    device=device), t, n)


def fft_correlate(xs: torch.Tensor, h, count: int) -> torch.Tensor:
    """Overlap-save correlation: f[s, i] = sum_t xs[s, i+t] h[t], i < count.

    ``h`` is a :class:`Spectrum` on ``xs``'s device, or host taps, whose
    spectrum is then computed for this call.
    """
    spec = h if isinstance(h, Spectrum) else spectrum(h, xs.dtype, xs.device)
    t, n = spec.taps, spec.n
    hop = n - t + 1
    k = -(-count // hop)                      # segments
    need = (k - 1) * hop + n
    if xs.shape[1] < need:
        xs = torch.cat([xs, xs.new_zeros((xs.shape[0], need - xs.shape[1]))],
                       dim=1)
    # Overlap-save keeps the last hop outputs of each N-point circular
    # convolution with reverse(h): for a segment starting at i0 they are
    # conv[i0 + t-1 .. i0 + n-1] = f[i0 ..].
    segs = xs.unfold(1, n, hop)[:, :k]         # [S, K, N], a view
    g = torch.fft.irfft(torch.fft.rfft(segs, dim=-1) * spec.H, n=n, dim=-1)
    return g[:, :, t - 1:].reshape(xs.shape[0], k * hop)[:, :count]


def _fft_decimate(plan: EnginePlan, xs: torch.Tensor, count: int,
                  h=None) -> torch.Tensor:
    """y[j] = f[j*M] where f is the full correlation with decim_coeffs
    (``h``: their :class:`Spectrum`, or None for the plan's taps)."""
    m = plan.factor
    f = fft_correlate(xs, plan.decim_coeffs if h is None else h,
                      (count - 1) * m + 1)
    return f[:, ::m][:, :count]


def _upsample_prototype(plan: EnginePlan) -> np.ndarray:
    """Interleave the phase FIRs into the zero-stuffed-domain prototype.

    With xz the factor-F zero-stuffing of xext (xz[iF] = xext[i]) and
    prototype P[p + (T1-1-tau)*F] = coeffs[p][tau], the prestage output is
    u[k] = corr(pad_left(xz, F-1), reverse(P))[k]: u[k] = sum_tau
    xext[i+tau] c[p][tau] with k = iF+p, written over xz[(i+tau)F],
    reindexed as a convolution in the stuffed domain, and turned into a
    correlation by tap reversal and an F-1 left pad.
    """
    f, t1 = plan.factor, plan.pre_taps
    proto = np.zeros(t1 * f, dtype=np.float64)
    for p in range(f):
        for tau in range(t1):
            proto[p + (t1 - 1 - tau) * f] = plan.pre_coeffs[p][tau]
    return proto


def _fft_upsample(plan: EnginePlan, xext: torch.Tensor, count: int,
                  drop: int) -> torch.Tensor:
    f = plan.factor
    nz = xext.shape[1] * f
    xz = xext.new_zeros((xext.shape[0], nz + f - 1))
    xz[:, f - 1::f] = xext                     # left pad F-1 + stuffing
    prot = _upsample_prototype(plan)
    u = fft_correlate(xz, prot[::-1], drop + count)
    return u[:, drop:drop + count]


def _fft_oneshot_apply(plan: EnginePlan, x: torch.Tensor) -> torch.Tensor:
    """The device part of :func:`fft_oneshot`: x [S, n] in its final dtype
    and device."""
    n = x.shape[1]
    lm = plan.lengths
    canonical = lm.canonical(n)
    if canonical <= 0 or n == 0:
        return x.new_zeros((x.shape[0], max(canonical, 0)))
    z = lm.flush_pad(n)
    zeros = x.new_zeros

    if plan.kind == 'decimate':
        need = (canonical - 1) * plan.factor + plan.decim_taps
        xs = torch.cat([x, zeros((x.shape[0], max(z, need - n)))], dim=1)
        return _fft_decimate(plan, xs, canonical)

    if plan.kind == 'dft_up':
        if plan.factor == 1:
            return x
        xext = torch.cat([zeros((x.shape[0], plan.pre_taps - 1)), x,
                          zeros((x.shape[0], z))], dim=1)
        return _fft_upsample(plan, xext, canonical, lm.drop_prefix())

    raise ValueError(
        "fft_oneshot lowers the long-FIR stages only (kinds 'decimate' "
        f"and 'dft_up'); got {plan.kind!r} — use engine.oneshot, whose "
        "fused matmul serves the polyphase topologies")


def fft_oneshot(plan: EnginePlan, x, dtype=None,
                device='cuda') -> torch.Tensor:
    """One-shot resample via FFT overlap-save (decimate / dft_up plans).

    Drop-in alternative to :func:`engine.oneshot` for the two long-FIR
    topologies, with its arguments: ``x`` [S, n] (numpy or tensor), the
    result a tensor on ``device``, float32 on the card.  It produces the
    same canonical stream (within rounding; equality tested at float64).
    Other kinds raise ``ValueError``.
    """
    from .oneshot import _entry_tensor

    x = _entry_tensor(x, dtype, device, "fft_oneshot")
    return _fft_oneshot_apply(plan, x)
