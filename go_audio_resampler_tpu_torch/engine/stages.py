"""Stage functions of the streaming engine over fixed-size blocks.

PyTorch counterpart of the JAX package's ``engine/stages.py``: every
stage is a function ``(state, x_block) -> (state', y_block, valid, n_out)``
over blocks with a leading batch ("streams") axis.  The serial fixed-point
phase walk of the reference polyphase stage (polyphase_stage.go:257-293)
is its closed form ``at_j = at_0 + j*step``, evaluated in parallel, and
the inner products become the K1 kernel (the prestage, on the card),
gathers and matmuls.

The walks' integers are those of the JAX package's two-limb int32
arithmetic; torch computes them in int64 (on the device, the limbs joined
into one accumulator), which holds every value the reference's bounds
allow (``count * s_lo < 2^31``).  The walk state itself (the history
length, the accumulator's limbs) is plain Python integers: each depends
only on sample counts, so a stage knows how many outputs it emits, and how
far the history shifts, without reading anything back from the device.

Alignment: the prestage keeps a zero-initialized carry of T1-1 samples,
so its output stream ``u`` is the reference's pre-stage output prefixed by
its convolution ramp of ``(T1-1)*factor`` samples.  The polyphase
accumulator therefore starts at ``at0 = (T1-1)*factor * L << 16``
(``EnginePlan.at0``), which lands its output grid on the reference's
sample positions.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.convolve import (ConvBand, _tier, conv1d_poly,
                            conv1d_poly_interleaved)
from ..ops.frames import gather_windows, gather_windows_at
from ..ops.precision import tiered_matmul

__all__ = [
    "walk16", "walk32", "PrestageState", "PolyState", "DecimState",
    "CubicState", "prestage_apply", "prestage_process", "fir_process",
    "poly_coeff_matrix", "gather_windows", "gather_windows_at",
    "POLY_EMIT_TILE", "poly_emit", "poly_process", "decim_process",
    "hermite4", "linear2", "linear_process", "cubic_process",
]


# ---------------------------------------------------------------------------
# Fixed-point phase walks (closed form, two 16-bit limbs)
# ---------------------------------------------------------------------------

def _walk16_at(j, at_hi, at_lo, q: int, s_lo: int):
    """:func:`walk16` at the indices ``j`` (a tensor, or an int on the
    host).  On a tensor the two limbs are one int64 accumulator
    ``(at_hi << 16) + at_lo + j*step``, whose integer part and fraction
    are the limbs' (the first term is a multiple of 2^16), in fewer
    launches."""
    if isinstance(j, torch.Tensor):
        acc = j * ((q << 16) + s_lo) + ((at_hi << 16) + at_lo)
        return acc >> 16, acc & 0xFFFF
    lo = at_lo + j * s_lo
    return at_hi + j * q + (lo >> 16), lo & 0xFFFF


def walk16(at_hi, at_lo, q: int, s_lo: int, count: int, device=None):
    """Closed-form 16-bit-fraction walk: at_j = at + j*step, j < count.

    ``at_hi`` is the accumulator's integer part (phase units, = at >> 16),
    ``at_lo`` its 16-bit fraction; step = q*2^16 + s_lo.  Returns
    (hi[count], frac[count]) as int64 tensors on ``device``.
    """
    j = torch.arange(count, dtype=torch.int64, device=device)
    return _walk16_at(j, at_hi, at_lo, q, s_lo)


def walk32(at_int, at_f1, at_f0, q: int, s_f1: int, s_f0: int, count: int,
           dtype=torch.float32, device=None):
    """Closed-form 32-bit-fraction walk with two 16-bit fraction limbs.

    step = q*2^32 + s_f1*2^16 + s_f0.  Returns (i[count], x[count]) where
    ``i`` is the integer part (int64) and ``x`` the fraction in [0, 1) in
    ``dtype``, formed in ``dtype`` in the JAX package's order.
    """
    # One int64 accumulator holds the three limbs: at_int + j*q < 2^31
    # (the JAX package's bound) keeps it below 2^63.
    acc = torch.arange(count, dtype=torch.int64, device=device) * (
        (q << 32) + (s_f1 << 16) + s_f0) + ((at_int << 32) + (at_f1 << 16)
                                            + at_f0)
    x = (((acc >> 16) & 0xFFFF).to(dtype)
         + (acc & 0xFFFF).to(dtype) * (1.0 / 65536.0)) * (1.0 / 65536.0)
    return acc >> 32, x


def _advance16(at_hi, at_lo, q: int, s_lo: int, n):
    """Advance a 16-bit-fraction accumulator by n steps."""
    lo = at_lo + n * s_lo
    return at_hi + n * q + (lo >> 16), lo & 0xFFFF


def _advance32(at_int, at_f1, at_f0, q: int, s_f1: int, s_f0: int, n):
    l0 = at_f0 + n * s_f0
    l1 = at_f1 + n * s_f1 + (l0 >> 16)
    return at_int + n * q + (l1 >> 16), l1 & 0xFFFF, l0 & 0xFFFF


def _count_below(f, count: int, limit: int) -> int:
    """How many j in [0, count) have f(j) < limit, for f nondecreasing
    (a walk's integer part): the outputs a step emits, on the host."""
    lo, hi = 0, count
    while lo < hi:
        mid = (lo + hi) // 2
        if f(mid) < limit:
            lo = mid + 1
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Stage states
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrestageState:
    carry: torch.Tensor     # [S, T1-1] trailing input samples (zeros-init)


@dataclasses.dataclass
class PolyState:
    hist: torch.Tensor      # [S, H] packed unconsumed u-stream
    hist_len: int
    at_hi: int              # phase units (= at >> 16)
    at_lo: int              # 16-bit fraction


@dataclasses.dataclass
class DecimState:
    carry: torch.Tensor     # [S, T-1]
    next_rel: int           # next output position relative to the block


@dataclasses.dataclass
class CubicState:
    carry: torch.Tensor     # [S, 3]
    at_int: int
    at_f1: int              # upper 16 fraction bits
    at_f0: int              # lower 16 fraction bits


# ---------------------------------------------------------------------------
# Prestage: integer-factor polyphase FIR upsampling (dft_stage.go:156-338)
# ---------------------------------------------------------------------------

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


def prestage_process(coeffs: torch.Tensor, state: PrestageState,
                     x: torch.Tensor, factor: int, precision: str = 'auto',
                     band: ConvBand | None = None):
    """Streaming prestage step: [S, B] in -> [S, F*B] out, carry T1-1.

    ``band`` is the banded lowering's operator for T1-1+B samples, which
    an engine builds once (``convolve.band_operator``)."""
    xext = torch.cat([state.carry.to(x.dtype), x], dim=1)
    u = prestage_apply(coeffs, xext, factor, precision, band=band)
    t1 = coeffs.shape[1]
    new_carry = xext[:, xext.shape[1] - (t1 - 1):].contiguous()
    return PrestageState(carry=new_carry), u


# ---------------------------------------------------------------------------
# 1:1 FIR stage (strict-antialias prefilter; beyond reference)
# ---------------------------------------------------------------------------

def fir_process(coeffs: torch.Tensor, carry: torch.Tensor, x: torch.Tensor,
                precision: str = 'auto', band: ConvBand | None = None):
    """Causal streaming FIR: [S, B] in -> [S, B] out, carry T-1 samples.

    Output i is c_i = sum_t coeffs[t] * (carry ++ x)[i + t]; returns
    (carry', y).  On the card the K1 kernel through the banded
    convolution, reading ``band``: the operator for T-1+B samples, which
    an engine builds once (``convolve.band_operator``).
    """
    xext = torch.cat([carry.to(x.dtype), x], dim=1)
    y = conv1d_poly(xext, coeffs[None, :].to(x.dtype), stride=1,
                    precision=precision, band=band)[:, 0, :]
    return xext[:, x.shape[1]:].contiguous(), y


# ---------------------------------------------------------------------------
# Polyphase stage with interpolated coefficients (polyphase_stage.go)
# ---------------------------------------------------------------------------

def poly_coeff_matrix(banks, phase: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Interpolated coefficient rows: A[p] + x*(B[p] + x*(C[p] + x*D[p])).

    ``banks`` = (A, B, C, D) each [L, T2]; phase [C], x [C] -> [C, T2].
    Reference parity: ops.CubicInterpDot's coefficient evaluation
    (simdops/ops.go:46-49) hoisted out of the dot product.
    """
    a, b, c, d = (bank.index_select(0, phase) for bank in banks)
    xx = x[:, None].to(banks[0].dtype)
    return a + xx * (b + xx * (c + xx * d))


#: outputs per banded-emit tile
POLY_EMIT_TILE = 256


def _banded_emit_on(hist: torch.Tensor) -> bool:
    """The emit's lowering: the banded tiles for float32 on the card (the
    JAX package's TPU choice), the per-output gather elsewhere (its CPU
    choice).  The two differ only in the order of the float sums."""
    return hist.device.type == 'cuda' and hist.dtype == torch.float32


def _poly_emit_banded(banks, hist: torch.Tensor, div: torch.Tensor,
                      phase: torch.Tensor, x: torch.Tensor, taps: int,
                      span: int, tv: int, precision: str = 'auto'):
    """Banded-tile lowering of the polyphase emit.

    Per tile of ``tv`` outputs the windows span at most ``span`` input
    samples, so each output's interpolated coefficient row is placed at its
    window offset inside a [tv, span] block ``b``, one slab of ``span``
    samples is gathered per tile (not one window per output), and the
    emit is a per-tile matmul ``[S, span] x [span, tv]``.  ``b`` is built
    by one scatter: each (tile, output, offset) receives at most one
    coefficient, so its values equal the JAX package's sum of ``taps``
    one-hot selects.
    """
    tier = _tier(precision)
    cap = div.shape[0]
    n_t = cap // tv
    k = poly_coeff_matrix(banks, phase, x)                   # [cap, T2]
    div_r = div.reshape(n_t, tv)
    i0 = div_r[:, 0]                                         # [n_t]
    rel = div_r - i0[:, None]                                # [n_t, tv]
    cols = rel[..., None] + torch.arange(taps, device=hist.device)
    b = torch.zeros((n_t, tv, span), dtype=hist.dtype, device=hist.device)
    b.scatter_(2, cols, k.reshape(n_t, tv, taps).to(hist.dtype))
    slab = gather_windows_at(hist, i0, span)                 # [S, n_t, span]
    y = tiered_matmul(slab, b, tier,
                      lambda p, q: torch.einsum('stw,tcw->stc', p, q))
    return y.reshape(hist.shape[0], cap)


def poly_emit(banks, hist: torch.Tensor, hist_len: int, at_hi: int,
              at_lo: int, num_phases: int, taps: int, step_hi: int,
              step_lo: int, cap: int, precision: str = 'auto'):
    """Emit up to ``cap`` polyphase outputs from the packed history.

    Returns (y[S, cap], valid[cap], n_out, at_hi', at_lo'): the valid
    outputs are left-packed (valid is monotone), ``n_out`` and the
    advanced accumulator are Python integers.  The emitted values equal
    the reference walk's outputs (same windows, same interpolated
    coefficients); the banded-tile lowering (float32 on the card) changes
    only the float accumulation order.  (The JAX package's ``out_tile``,
    which no caller sets, is not ported.)
    """
    tier = _tier(precision)
    hist_len, at_hi, at_lo = int(hist_len), int(at_hi), int(at_lo)
    L = num_phases
    limit = (hist_len - taps + 1) * L
    n_out = _count_below(
        lambda j: _walk16_at(j, at_hi, at_lo, step_hi, step_lo)[0],
        cap, limit)
    banded = _banded_emit_on(hist) and cap >= 128
    if banded:
        tv = POLY_EMIT_TILE if cap >= POLY_EMIT_TILE else 128
        # Edge padding to whole tiles: the walk at clamped indices.
        j = torch.arange(cap - cap % -tv, dtype=torch.int64,
                         device=hist.device).clamp_(max=cap - 1)
    else:
        j = torch.arange(cap, dtype=torch.int64, device=hist.device)
    hi, frac = _walk16_at(j, at_hi, at_lo, step_hi, step_lo)
    div = torch.div(hi, L, rounding_mode='floor')
    phase = hi - div * L
    x = frac.to(hist.dtype) * (1.0 / 65536.0)
    if banded:
        # Static span bound: over k < tv outputs the accumulator's integer
        # part advances by at most (tv-1)*step_hi + (tv-1) (16-bit carry),
        # so the window starts move < that // L + 1.
        div_adv = ((tv - 1) * (step_hi + 1)) // L + 1
        span = -(-(div_adv + taps) // 128) * 128
        y = _poly_emit_banded(banks, hist, div, phase, x, taps, span, tv,
                              tier)[:, :cap]
        hi = hi[:cap]
    else:
        k = poly_coeff_matrix(banks, phase, x)               # [cap, T2]
        w = gather_windows_at(hist, div, taps)               # [S, cap, T2]
        y = tiered_matmul(w, k.to(hist.dtype), tier,
                          lambda a, b: torch.einsum('sct,ct->sc', a, b))
    valid = hi < limit
    y = y * valid.to(y.dtype)[None, :]
    at_hi2, at_lo2 = _advance16(at_hi, at_lo, step_hi, step_lo, n_out)
    return y, valid, n_out, at_hi2, at_lo2


def poly_process(banks, state: PolyState, u: torch.Tensor, num_phases: int,
                 taps: int, step_hi: int, step_lo: int, cap: int,
                 precision: str = 'auto'):
    """Streaming polyphase step: append u, emit, consume, rebase.

    Returns (state', y[S, cap], valid[cap], n_out).  The history holds
    ``hist_len`` live samples of a fixed width H; appending past H is a
    sizing bug and raises (the JAX package's dynamic_update_slice would
    clamp the start instead).
    """
    m = u.shape[1]
    hl, size = state.hist_len, state.hist.shape[1]
    if hl + m > size:
        raise ValueError(f"poly_process: {hl} history samples and {m} new "
                         f"ones exceed the history's {size}")
    hist = torch.cat([state.hist[:, :hl], u.to(state.hist.dtype),
                      state.hist[:, hl + m:]], dim=1)
    hist_len = hl + m
    y, valid, n_out, at_hi, at_lo = poly_emit(
        banks, hist, hist_len, state.at_hi, state.at_lo,
        num_phases, taps, step_hi, step_lo, cap, precision=precision)
    consumed = min(at_hi // num_phases, hist_len)
    if consumed:
        hist = torch.roll(hist, -consumed, dims=1)
    new_state = PolyState(hist=hist, hist_len=hist_len - consumed,
                          at_hi=at_hi - consumed * num_phases, at_lo=at_lo)
    return new_state, y, valid, n_out


# ---------------------------------------------------------------------------
# Decimation stage (dft_stage.go:488-553)
# ---------------------------------------------------------------------------

def decim_process(coeffs: torch.Tensor, state: DecimState, x: torch.Tensor,
                  factor: int, precision: str = 'auto'):
    """Streaming decimation: strided FIR at absolute positions next_rel + j*M.

    The carry holds T-1 zero-initialized samples and ``next_rel`` starts at
    T-1, so emitted windows contain only real samples and values equal the
    reference's.  Returns (state', y[S, cap], valid[cap], n_out), the
    valid outputs left-packed.  (The engine streams decimation through
    the fused banded step; this stage is the reference's standalone one.)
    """
    m = factor
    t = coeffs.shape[0]
    s, b = x.shape
    histbuf = torch.cat([state.carry.to(x.dtype), x], dim=1)  # [S, T-1+B]
    cap = (b + m - 1) // m + 1
    r = state.next_rel % m
    lw = (cap - 1) * m + t
    padded = torch.cat([histbuf, x.new_zeros((s, 2 * m + 1))], dim=1)
    window = padded[:, r:r + lw].contiguous()
    out = conv1d_poly(window, coeffs[None, :], stride=m,
                      precision=precision)[:, 0, :]           # [S, cap]
    pos = r + torch.arange(cap, device=x.device) * m
    valid = (pos >= state.next_rel) & (pos < b)
    k0 = (state.next_rel - r) // m
    n_out = max(0, min(cap, (b - r + m - 1) // m) - max(k0, 0))
    y = torch.roll(out * valid.to(out.dtype)[None, :], -k0, dims=1)
    valid_packed = torch.roll(valid, -k0)
    new_state = DecimState(carry=histbuf[:, b:].contiguous(),
                           next_rel=state.next_rel + n_out * m - b)
    return new_state, y, valid_packed, n_out


# ---------------------------------------------------------------------------
# Cubic stage (cubic.go:33-90) with exact 32-bit fixed-point walk
# ---------------------------------------------------------------------------

def hermite4(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SOXR cr-core.c 4-point cubic: w [S, C, 4], x [C] -> [S, C].

    s[-1]=w[...,0], s[0]=w[...,1], s[1]=w[...,2], s[2]=w[...,3];
    b = 0.5*(s1+s_m1) - s0; a = (1/6)*(s2-s1+s_m1-s0-4b); c = s1-s0-a-b;
    y = ((a*x + b)*x + c)*x + s0.  (cubic.go:75-90)
    """
    sm1, s0, s1, s2 = w.unbind(-1)
    b = 0.5 * (s1 + sm1) - s0
    a = (1.0 / 6.0) * (s2 - s1 + sm1 - s0 - 4.0 * b)
    c = s1 - s0 - a - b
    xx = x[None, :].to(w.dtype)
    return ((a * xx + b) * xx + c) * xx + s0


def linear2(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """2-point linear interpolation: w [S, C, 2], x [C] -> [S, C].

    Counterpart of the reference's LinearStage kernel (cubic.go:158-183):
    y = (1-x)*prev + x*current.  The planner never selects it, as in the
    reference.
    """
    prev, cur = w.unbind(-1)
    xx = x[None, :].to(w.dtype)
    return (1.0 - xx) * prev + xx * cur


def _interp_process(state: CubicState, x: torch.Tensor, cubic_step: int,
                    cap: int, offset: int, width: int, interp):
    """The cubic and linear stages' shared step: walk, gather the
    ``width``-sample windows at ``offset`` past each integer position,
    interpolate, rebase."""
    b = x.shape[1]
    histbuf = torch.cat([state.carry.to(x.dtype), x], dim=1)  # [S, B+3]
    q = cubic_step >> 32
    s_f1 = (cubic_step >> 16) & 0xFFFF
    s_f0 = cubic_step & 0xFFFF
    i, frac = walk32(state.at_int, state.at_f1, state.at_f0, q, s_f1, s_f0,
                     cap, dtype=x.dtype, device=x.device)
    valid = i < b
    w = gather_windows_at(histbuf, i.clamp(0, b - 1) + offset, width)
    y = interp(w, frac) * valid.to(x.dtype)[None, :]
    n_out = _count_below(lambda j: _advance32(
        state.at_int, state.at_f1, state.at_f0, q, s_f1, s_f0, j)[0], cap, b)
    at_int, at_f1, at_f0 = _advance32(
        state.at_int, state.at_f1, state.at_f0, q, s_f1, s_f0, n_out)
    new_state = CubicState(carry=histbuf[:, b:].contiguous(),
                           at_int=at_int - b, at_f1=at_f1, at_f0=at_f0)
    return new_state, y, valid, n_out


def linear_process(state: CubicState, x: torch.Tensor, cubic_step: int,
                   cap: int):
    """Streaming linear-interpolation step (LinearStage, cubic.go:141-229).

    Shares CubicState (the 3-sample carry is wider than the 1 sample
    needed; the walk and bookkeeping are the cubic stage's): the window
    [prev, cur] is histbuf[i+2 : i+4].
    """
    return _interp_process(state, x, cubic_step, cap, 2, 2, linear2)


def cubic_process(state: CubicState, x: torch.Tensor, cubic_step: int,
                  cap: int):
    """Streaming cubic interpolation step over a fixed block."""
    return _interp_process(state, x, cubic_step, cap, 0, 4, hermite4)
