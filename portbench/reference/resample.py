"""The plain reference: float64 stage-by-stage resampling in PyTorch.

Each stage is applied directly from the filters of :mod:`.design`, on
whatever device the caller's tensors live (the card after a run's window,
the CPU in the tests).  Nothing here imports the program.

The canonical output stream is the Go library's ``Process(x); Flush()``
stream:

- integer decimation by M with the T-tap filter c: ``y[j] = sum_t c[t] *
  x[j*M + t]``, x zero beyond its end, for ``j < decimation_length(n)``;
- the two-stage exact-rational walk (the 2x prestage, then L phases of
  T2 taps, s = step >> 16 prestage samples an L outputs):
  ``u[i*F + p] = sum_tau pre[p, tau] * x[i + tau]`` and
  ``y[j] = sum_t bank[(j*s) % L, t] * u[(j*s) // L + t]``.

``tf32=True`` computes in float32 on operands rounded to TF32 (10 bits of
mantissa, to nearest), as one pass of the tensor cores' TF32 product
would: the control that a float32 result must be told apart from.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .design import Decimation, TwoStage

#: Outputs per block of the reference's products (bounds its memory).
BLOCK_OUTPUTS = 1 << 16


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10-bit mantissa, to nearest (ties
    away from zero), as float32 values."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _operands(x: torch.Tensor, w: torch.Tensor, tf32: bool):
    if tf32:
        return tf32_round(x), tf32_round(w.to(x.device))
    return x.to(torch.float64), w.to(device=x.device, dtype=torch.float64)


def decimation_length(n: int, factor: int, taps: int) -> int:
    """Outputs of ``Process(n samples); Flush()`` of the Go library's
    decimation stage (dft_stage.go: the history, the phase carry and the
    flush of ``taps`` zeros)."""
    if n <= 0:
        return 0
    hist, phase, total = 0, 0, 0
    for feed in (n, taps):
        hist += feed
        if hist < taps:
            continue
        filterable = hist - taps + 1
        total += max(0, -(-(filterable - phase) // factor))
        phase = ((phase - filterable) % factor + factor) % factor
        hist -= filterable
    return total


def decimate(x: torch.Tensor, dec: Decimation, tf32: bool = False
             ) -> torch.Tensor:
    """The canonical one-shot stream of ``x`` [S, n]: [S,
    decimation_length(n)], in float64 (float32 with ``tf32``)."""
    s, n = x.shape
    taps = len(dec.coeffs)
    count = decimation_length(n, dec.factor, taps)
    outs = []
    for j0 in range(0, count, BLOCK_OUTPUTS):
        j1 = min(count, j0 + BLOCK_OUTPUTS)
        a, b = j0 * dec.factor, (j1 - 1) * dec.factor + taps
        xs = x[:, a:min(b, n)]
        outs.append(_decimate_block(F.pad(xs, (0, b - a - xs.shape[1])),
                                    dec, tf32))
    if not outs:
        return x.new_zeros((s, 0), dtype=torch.float64)
    return torch.cat(outs, dim=1)


def due(filters, n: int) -> int:
    """How many outputs of the canonical stream read only the first ``n``
    input samples."""
    if isinstance(filters, Decimation):
        taps = len(filters.coeffs)
        return max(0, (n - taps) // filters.factor + 1)
    return two_stage_due(filters, n)


def stream(x_of, filters, j0: int, j1: int, tf32: bool = False
           ) -> torch.Tensor:
    """Outputs ``j0 .. j1-1`` of the canonical stream of the input that
    ``x_of(a, b)`` reads (see :func:`two_stage`)."""
    if isinstance(filters, Decimation):
        m, taps = filters.factor, len(filters.coeffs)
        return _decimate_block(x_of(j0 * m, (j1 - 1) * m + taps), filters,
                               tf32)
    return two_stage(x_of, filters, j0, j1, tf32)


def _decimate_block(xs: torch.Tensor, dec: Decimation, tf32: bool
                    ) -> torch.Tensor:
    """Every full window of ``xs`` at stride M against the filter."""
    w = torch.as_tensor(dec.coeffs)[None, None, :]
    xs, w = _operands(xs, w, tf32)
    return F.conv1d(xs[:, None, :], w, stride=dec.factor)[:, 0]


def two_stage_due(ts: TwoStage, n: int) -> int:
    """How many outputs of the canonical stream read only the first ``n``
    input samples: output j reads x up to ``((j*s)//L + T2 - 1)//F + T1 -
    1``."""
    step = ts.step >> 16
    last_u = ts.factor * (n - ts.pre.shape[1] + 1) - ts.bank.shape[1]
    if last_u < 0:
        return 0
    return -(-(last_u + 1) * ts.num_phases // step)


def two_stage(x_of, ts: TwoStage, j0: int, j1: int, tf32: bool = False
              ) -> torch.Tensor:
    """Outputs ``j0 .. j1-1`` of the canonical stream, [S, j1 - j0].

    ``x_of(a, b)`` returns the input's samples ``a .. b-1`` as [S, b - a]
    (zeros past its end): the reference reads only the windows these
    outputs need, so a long stream is checked at a few places cheaply.
    """
    f, (_, t1) = ts.factor, ts.pre.shape
    t2, big_l, step = ts.bank.shape[1], ts.num_phases, ts.step >> 16
    outs = []
    for c0 in range(j0, j1, BLOCK_OUTPUTS):
        c1 = min(j1, c0 + BLOCK_OUTPUTS)
        d0 = c0 * step // big_l
        d1 = (c1 - 1) * step // big_l + t2          # u[d0 : d1]
        a = d0 // f
        xs = x_of(a, (d1 - 1) // f + t1)
        pre = torch.as_tensor(ts.pre)[:, None, :]
        xs, pre = _operands(xs, pre, tf32)
        # The prestage: u[(a + w)*F + p] = u_blk[:, w*F + p].
        u = F.conv1d(xs[:, None, :], pre).transpose(1, 2).reshape(
            xs.shape[0], -1)
        if tf32:
            u = tf32_round(u)
        j = torch.arange(c0, c1, device=u.device)
        start = j * step // big_l - a * f
        phase = j * step % big_l
        taps = torch.arange(t2, device=u.device)
        win = u[:, start[:, None] + taps[None, :]]       # [S, n, T2]
        bank = torch.as_tensor(ts.bank)
        bank = (tf32_round(bank.to(u.device)) if tf32
                else bank.to(u.device, torch.float64))
        outs.append(torch.einsum("snt,nt->sn", win, bank[phase]))
    return torch.cat(outs, dim=1)
