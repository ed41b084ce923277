"""One-shot resampling, and the banded-operator builders it shares with
the streaming paths.

Counterpart of the JAX package's ``engine/oneshot.py``.  For a known input
length everything but the signal is fixed on the host: the flush padding,
the canonical output length, the whole fixed-point phase walk and the
banded matrices, all computed in exact numpy int64 / float64 and bit-equal
to the JAX package's.  The device work is then one kernel launch per call:

- exact-rational two-stage plans: one periodic banded operator over the
  raw input, the K1 kernel (``ops/fused.py``);
- integer decimation: a banded per-period matrix, K1;
- integer upsampling (``dft_up``): the polyphase prestage through the
  banded convolution of ``ops/convolve.py``, K1;
- the general (non-exact) two-stage walk and the cubic (QUICK) walk: one
  banded matrix per tile of 256 outputs at a data-dependent start, the K3
  kernel (``ops/general.py``).

Each call runs at the process-wide matmul tier (``GAR_TPU_MATMUL_PRECISION``,
read once per call; ``ops/precision.py``), as the JAX package's one-shot
path does, and each kernel call goes through the dispatch gate
(``precision.dispatch_allowed``: its plain version inside ``force_xla``).
On CPU tensors each kernel's wrapper computes its plain version.

The strict-antialias prefilter (``aa_taps > 0``) of an exact-rational
plan is composed into its banded operator (``pipeline/fused.compose``),
whose left context ``lam`` the apply pads; a non-exact plan runs it
first, as a 1:1 FIR through the banded convolution (K1), then the K3
path.  As in the JAX package, prefilters of ``FFT_CONV_MIN_TAPS`` taps or
more and decimation filters of ``DECIM_FFT_MIN_TAPS`` taps or more run
through FFT overlap-save (``engine/fftstage.py``, ``torch.fft``) instead,
with the filter's spectrum prepared in the aux.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from ..filterdesign.params import PHASE_FRAC_BITS
from ..ops import banded, convolve, fused, general
from ..ops.precision import check_tier, dispatch_allowed, dot_precision
from ..utils.spans import (ONESHOT_APPLY, ONESHOT_AUX, ONESHOT_DESIGN,
                           ONESHOT_UPLOAD, span)
from . import fftstage
from .counts import CubicSim
from .plan import EnginePlan
from .stages import prestage_apply

_FRAC = 1 << PHASE_FRAC_BITS

#: 1:1-FIR prototype length at and above which the JAX package filters the
#: strict-antialias prefilter of a non-exact plan by FFT overlap-save
#: (``engine/fftstage.py``), not the banded convolution.
FFT_CONV_MIN_TAPS = 6144

#: Crossover for routing the decimate topology through FFT overlap-save
#: (taps >= this).  It lies above the 8191-tap design cap, so the banded
#: matmul (K1) takes every designable plan; tests lower it to reach the
#: FFT route.  A constant, where the JAX package reads
#: ``GAR_DECIM_FFT_MIN_TAPS``: a crossover measured on the JAX package's
#: chip does not carry over to the card.
DECIM_FFT_MIN_TAPS = 16384


def _poly_walk_host(plan: EnginePlan, count: int):
    """Host-side exact walk: (div, phase, frac) for outputs 0..count-1."""
    at = plan.at0 + np.arange(count, dtype=np.int64) * plan.step
    hi = at >> PHASE_FRAC_BITS
    div = hi // plan.num_phases
    phase = hi % plan.num_phases
    frac = at & (_FRAC - 1)
    return div.astype(np.int64), phase.astype(np.int64), frac.astype(np.int64)


GENERAL_TILE = 256

# LRU cache of host-side banded matrices, keyed on the plan FINGERPRINT
# (not id: see EnginePlan.fingerprint) and bounded in bytes: a service
# hitting many distinct input lengths otherwise grows without limit (each
# (plan, length) entry is tens of MB).
_GENERAL_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_GENERAL_CACHE_BYTES = 0
GENERAL_CACHE_LIMIT = 512 << 20


def _cache_get(key):
    val = _GENERAL_CACHE.get(key)
    if val is not None:
        _GENERAL_CACHE.move_to_end(key)
    return val


def _cache_put(key, val):
    global _GENERAL_CACHE_BYTES
    _GENERAL_CACHE[key] = val
    _GENERAL_CACHE_BYTES += sum(a.nbytes for a in val)
    while _GENERAL_CACHE_BYTES > GENERAL_CACHE_LIMIT and len(_GENERAL_CACHE) > 1:
        _, old = _GENERAL_CACHE.popitem(last=False)
        _GENERAL_CACHE_BYTES -= sum(a.nbytes for a in old)
    return val


def _general_matrices(plan: EnginePlan, count: int,
                      tile: int = GENERAL_TILE):
    """Host-side banded tile matrices for the general path (cached).

    Returns (starts [n_tiles] int64, M [n_tiles, tile, Wx] float64) in
    the PRESTAGE-COMPOSED x domain: output t*tile + p reads
    ``xext[starts[t] : starts[t] + Wx] @ M[t, p]`` where ``xext`` is the
    raw input left-padded by T1-1 (the prestage ramp).  Composing the 2x
    prestage into the matrices removes the upsampled stream u: the device
    reads x once instead of writing and reading a 2x intermediate.

    The composition runs as two class-einsums: the u->x change of basis
    depends only on the tile's u-start parity, so tiles split into F
    classes sharing one [W_u, Wx] prestage matrix each.
    """
    key = (plan.fingerprint, count, tile)
    cached = _cache_get(key)
    if cached is not None:
        return cached
    div, phase, frac = _poly_walk_host(plan, count)
    x = (frac.astype(np.float64) / _FRAC)[:, None]
    K_host = (plan.bank_a[phase] + x * (plan.bank_b[phase] +
              x * (plan.bank_c[phase] + x * plan.bank_d[phase])))
    t2 = plan.poly_taps
    padded = -(-count // tile) * tile
    div_p = np.pad(div, (0, padded - count), mode='edge')
    K_p = np.pad(K_host, ((0, padded - count), (0, 0)))
    div_r = div_p.reshape(-1, tile)                # [n_tiles, P]
    starts_u = div_r[:, 0].copy()                  # [n_tiles] u-domain
    offs = div_r - starts_u[:, None]               # >= 0, monotone
    w_u = int(offs[:, -1].max()) + t2
    n_tiles = div_r.shape[0]
    M_u = np.zeros((n_tiles, tile, w_u), dtype=np.float64)
    rows = np.repeat(np.arange(n_tiles), tile)
    cols = np.tile(np.arange(tile), n_tiles)
    for t in range(t2):
        M_u[rows, cols, offs.ravel() + t] = K_p[:, t]

    # Compose the prestage: u[m] = sum_tau pre[m % F, tau] * xext[m//F + tau]
    # => per u-start class c = start_u % F, the change of basis is
    # P_c[m, (m+c)//F + tau] = pre[(m+c) % F, tau], shared by all tiles
    # of that class; starts_x = starts_u // F.
    F, T1 = plan.factor, plan.pre_taps
    pre = plan.pre_coeffs
    w_x = (w_u - 1 + F - 1) // F + T1
    starts_x = starts_u // F
    M = np.empty((n_tiles, tile, w_x), dtype=np.float64)
    for c in range(F):
        sel = np.nonzero(starts_u % F == c)[0]
        if not len(sel):
            continue
        P_c = np.zeros((w_u, w_x), dtype=np.float64)
        for m in range(w_u):
            base = (m + c) // F
            P_c[m, base:base + T1] = pre[(m + c) % F]
        M[sel] = np.einsum('tpu,uw->tpw', M_u[sel], P_c)
    return _cache_put(key, (starts_x, M))


def _cubic_matrices(plan: EnginePlan, count: int,
                    tile: int = GENERAL_TILE):
    """Banded tile matrices for the cubic (QUICK) walk (cached).

    Same structure as _general_matrices with 4-tap rows: output j reads
    histbuf[i_j .. i_j+3] (histbuf = x left-padded by 3) against the
    Catmull-Rom basis evaluated at frac_j.  The basis weights are
    extracted numerically by pushing unit taps through the hermite
    formula, so the matmul is bit-faithful to it.
    """
    key = ('cubic', plan.fingerprint, count, tile)
    cached = _cache_get(key)
    if cached is not None:
        return cached
    at = np.arange(count, dtype=np.int64) * plan.cubic_step
    i = (at >> CubicSim.FRAC_BITS).astype(np.int64)
    fr = (at & ((1 << CubicSim.FRAC_BITS) - 1)).astype(np.float64) \
        / (1 << CubicSim.FRAC_BITS)
    # Basis: y = a x^3 + b x^2 + c x + s0 with a, b, c linear in taps.
    K = np.empty((count, 4), dtype=np.float64)
    for k in range(4):
        sm1, s0, s1, s2 = (1.0 if k == 0 else 0.0), (1.0 if k == 1 else 0.0), \
            (1.0 if k == 2 else 0.0), (1.0 if k == 3 else 0.0)
        b = 0.5 * (s1 + sm1) - s0
        a = (1.0 / 6.0) * (s2 - s1 + sm1 - s0 - 4.0 * b)
        c = s1 - s0 - a - b
        K[:, k] = ((a * fr + b) * fr + c) * fr + s0
    padded = -(-count // tile) * tile
    div_p = np.pad(i, (0, padded - count), mode='edge')
    K_p = np.pad(K, ((0, padded - count), (0, 0)))
    div_r = div_p.reshape(-1, tile)
    starts = div_r[:, 0].copy()
    offs = div_r - starts[:, None]
    w_band = int(offs[:, -1].max()) + 4
    n_tiles = div_r.shape[0]
    M = np.zeros((n_tiles, tile, w_band), dtype=np.float64)
    rows = np.repeat(np.arange(n_tiles), tile)
    cols = np.tile(np.arange(tile), n_tiles)
    for t in range(4):
        M[rows, cols, offs.ravel() + t] = K_p[:, t]
    return _cache_put(key, (starts, M))


_DECIM_CACHE: dict = {}
DECIM_PERIOD = 256  # outputs per frame for the decimation frames-matmul
#: Outputs per frame on the kernel path (the JAX package's Pallas period).
PALLAS_DECIM_PERIOD = 128


def _decim_matrix(plan: EnginePlan, period: int = DECIM_PERIOD):
    """Banded per-period matrix for integer decimation.

    Output j reads x~[j*M : j*M + T]; grouping P outputs per frame gives
    frames of width W = (P-1)*M + T with stride P*M and a constant
    [P, W] matrix R[r, r*M : r*M + T] = coeffs, one matmul per frame
    instead of a long strided convolution.  Returns (R, P, P*M), cached.
    """
    key = (plan.fingerprint, period)
    if key in _DECIM_CACHE:
        return _DECIM_CACHE[key]
    m, t = plan.factor, plan.decim_taps
    p = period
    w = (p - 1) * m + t
    r = np.zeros((p, w), dtype=np.float64)
    for row in range(p):
        r[row, row * m:row * m + t] = plan.decim_coeffs
    _DECIM_CACHE[key] = (r, p, p * m)
    return _DECIM_CACHE[key]


def superframe(r: np.ndarray, ipx: int, *, max_overlap: float = 1.5,
               max_bytes: int = 64 << 20, kf_cap: int | None = None):
    """Group kf periods per frame: block-Toeplitz [kf*P, W + (kf-1)*I].

    A banded operator with W >> I makes the dense-frames lowering read
    each input ~W/I times.  Framing kf periods together amortizes the
    overlap: frames advance kf*I and read W + (kf-1)*I, so the read
    amplification drops to 1 + (W-I)/(kf*I) (<= 1 + max_overlap by choice
    of kf), at the cost of a [kf*P, W+(kf-1)*I] matrix whose zeros add
    ~max_overlap extra multiply-adds.  Returns (r_super, ipx_super);
    identity when already compact (the 1.5 default leaves moderately
    overlapped shapes like CD->DAT, W/I = 2.3, as they are).

    ``kf_cap`` bounds the super-period in input samples (streaming
    engines cap it near their block size to keep latency).
    """
    p, w = r.shape
    if ipx <= 0 or w - ipx <= max_overlap * ipx:
        return r, ipx
    kf = -(-(w - ipx) // max(int(max_overlap * ipx), 1))
    if kf_cap is not None:
        kf = min(kf, max(kf_cap, 1))
    while kf > 1 and (w + (kf - 1) * ipx) * (kf * p) * 4 > max_bytes:
        kf -= 1
    if kf <= 1:
        return r, ipx
    ws = w + (kf - 1) * ipx
    rs = np.zeros((kf * p, ws), dtype=r.dtype)
    for f in range(kf):
        rs[f * p:(f + 1) * p, f * ipx:f * ipx + w] = r
    return rs, kf * ipx


_FUSED_CACHE: dict = {}


def _fused_rational_matrix(plan: EnginePlan):
    """Compose prestage + polyphase into one per-period matrix over x.

    For exact-rational ratios both stages are periodically time-varying
    linear operators; their composition is again periodic.  With the
    engine's alignment (prestage zero-carry + at0 = (T1-1)*F*L<<16) the
    m-th frame of the composed operator starts exactly at x[m * Ipx]:

      output j = m*P2 + r  reads u[delta + m*Ipu + (r*s)//L : +T2]
      u[i*F + p][x] = sum_tau pre[p, tau] * x[i + tau - (T1-1)]
      => x-coefficient index rel. frame start = (div+t)//F + tau - (T1-1)
         - m*Ipx, which is >= 0 with min 0 (delta//F == T1-1).

    The strict-antialias prefilter (``aa_taps > 0``), a delay-compensated
    1:1 FIR, is composed in ahead of both stages
    (``pipeline/fused.compose``); its half-length becomes the operator's
    left zero-context ``lam``.

    Returns (R [P2, Wx], P2 outputs/period, Ipx input samples/period,
    lam left zero-context).  Computed once per plan in float64 and cached.
    """
    key = plan.fingerprint
    if key in _FUSED_CACHE:
        return _FUSED_CACHE[key]
    s = plan.step >> PHASE_FRAC_BITS
    L = plan.num_phases
    F = plan.factor
    T1 = plan.pre_taps
    T2 = plan.poly_taps
    g = math.gcd(s, L)
    P = L // g
    Ip = s // g                      # u samples per P outputs
    k = F // math.gcd(Ip, F)         # periods to make the u stride F-aligned
    P2 = k * P
    Ipu = k * Ip
    Ipx = Ipu // F                   # input samples per frame
    delta = plan.lengths.core_delta()
    assert delta // F == T1 - 1 and delta % F == 0

    pre = plan.pre_coeffs            # [F, T1] float64, tap-reversed
    A = plan.bank_a                  # [L, T2] float64, tap-reversed
    wx = (delta + Ipu - 1 + T2 - 1) // F + (T1 - 1) - (T1 - 1) + 1
    R = np.zeros((P2, wx), dtype=np.float64)
    max_j = 0
    for r in range(P2):
        o_r = delta + (r * s) // L   # u index of window start (m=0 frame)
        ph = (r * s) % L
        for t in range(T2):
            m_u = o_r + t
            i = m_u // F
            p = m_u % F
            a = A[ph, t]
            if a == 0.0:
                continue
            # u[m_u] = sum_tau pre[p, tau] * x[i + tau - (T1-1)]
            j0 = i - (T1 - 1)
            R[r, j0:j0 + T1] += a * pre[p]
            max_j = max(max_j, j0 + T1 - 1)
    R = R[:, :max_j + 1]
    lam = 0
    if plan.aa_taps:
        from ..pipeline.fused import BandedOp, compose
        d = (plan.aa_taps - 1) // 2
        aa = BandedOp(P=1, I=1, W=plan.aa_taps,
                      R=np.asarray(plan.aa_coeffs,
                                   dtype=np.float64)[None, :],
                      lam=d, lengths=())
        core = BandedOp(P=P2, I=Ipx, W=R.shape[1], R=R, lam=0, lengths=())
        comp = compose(aa, core)
        R, P2, Ipx, lam = comp.R, comp.P, comp.I, comp.lam
    _FUSED_CACHE[key] = (R, P2, Ipx, lam)
    return _FUSED_CACHE[key]


# -- device side ----------------------------------------------------------

def _pad_right(x: torch.Tensor, need: int) -> torch.Tensor:
    """x [S, n] zero-extended to at least ``need`` columns, contiguous."""
    if x.shape[1] >= need:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((x.shape[0], need - x.shape[1]))],
                     dim=1)


def _pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """x [S, n] with ``left`` and ``right`` zero columns around it."""
    z = x.new_zeros
    return torch.cat([z((x.shape[0], left)), x, z((x.shape[0], right))],
                     dim=1)


def _matrix_t(r: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A host float64 [P, W] operator as R_t [W, P] on the device."""
    with span(ONESHOT_UPLOAD):
        return torch.as_tensor(np.ascontiguousarray(r.T), dtype=dtype,
                               device=device)


def _banded_aux(r: np.ndarray, ipx: int, dtype: torch.dtype, device,
                tier: str, lam: int = 0):
    """(R_t, Ipx, op, lam) of a periodic banded operator with left
    zero-context ``lam``: R_t on the device and, on the card, R_t as K1
    reads it at ``tier`` (``banded.prepare``; None on the CPU)."""
    r_t = _matrix_t(r, dtype, device)
    return r_t, ipx, banded.prepare_on_card(r_t, tier), lam


def _banded_tiles_apply(u: torch.Tensor, aux, last_start: int, count: int,
                        tier: str) -> torch.Tensor:
    """Apply per-tile banded matrices: the general/cubic one-shot core.

    ``aux`` is (starts, M [n_tiles, w_band, tile], bands, warpgroups) on
    ``u``'s device (:func:`_upload`).  The K3 kernel on the card reads each
    tile's window of ``u`` in place and M within its bands; on the CPU (or
    inside ``force_xla``) its plain version gathers the windows.  Both at
    ``tier``.
    """
    starts_d, m_d, bands, warpgroups = aux[:4]
    w_band, tile = int(m_d.shape[1]), int(m_d.shape[2])
    u = _pad_right(u, last_start + w_band)
    kw = dict(w_band=w_band, tile=tile, tier=tier)
    if dispatch_allowed(tier):
        y = general.general_resample(u, m_d, starts_d, bands=bands,
                                     warpgroups=warpgroups, **kw)
    else:
        y = general.general_resample_reference(u, m_d, starts_d, **kw)
    return y[:, :count]


def _poly_apply_general(plan: EnginePlan, xext: torch.Tensor, count: int,
                        aux, tier: str) -> torch.Tensor:
    """Banded batched matmul for non-exact-rational ratios (K3).

    The walk is quasi-periodic, so no single per-period matrix exists,
    but within a tile of outputs the windows span a bounded range, so
    each tile gets its own banded matrix (prestage composed in; see
    _general_matrices) over windows of ``xext`` (the raw input
    left-padded by T1-1).  ``aux`` is (starts, M, bands, warpgroups) on
    the device.
    """
    # The last output's u-domain window start (the walk's last div), in x.
    at_last = plan.at0 + (count - 1) * plan.step
    last_start = ((at_last >> PHASE_FRAC_BITS) // plan.num_phases
                  // plan.factor)
    return _banded_tiles_apply(xext, aux, last_start, count, tier)


def _banded_apply(x: torch.Tensor, count: int, aux,
                  tier: str) -> torch.Tensor:
    """One periodic banded operator over the input (K1): the JAX
    package's ``_poly_apply_rational_fused`` and ``_decim_apply_matmul``.

    Frames of ``x`` of width Wx advance Ipx per P outputs; ``aux`` is
    (R_t [Wx, P], Ipx, op, lam) from :func:`_banded_aux`, at ``tier``.
    K1 reads ``x`` in place, behind ``lam`` zeros (the strict-antialias
    prefilter's context) and followed by zeros up to the last frame's end
    (``fused_resample``'s ``head`` and ``width``): no padded copy of the
    input, no intermediate stream and no frames are materialized.
    """
    r_t, ipx, op, lam = aux
    wx, p2 = r_t.shape
    n_frames = -(-count // p2)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=n_frames, tier=tier,
              head=lam or None, width=(n_frames - 1) * ipx + wx)
    if x.stride(1) != 1:
        x = x.contiguous()
    if dispatch_allowed(tier):
        y = fused.fused_resample(x, r_t, op=op, **kw)
    else:
        y = fused.fused_resample_reference(x, r_t, **kw)
    return y[:, :count]


def _upload(starts_m, dtype: torch.dtype, device):
    """(starts, M [n_tiles, tile, W]) from the host to the device as
    (starts int64, M [n_tiles, W, tile] in ``dtype``, bands, warpgroups),
    the layout K3 reads; ``bands`` is M's band table
    (``general.band_table``) and ``warpgroups`` the kernel's block width
    for it (``general.block_warpgroups``), both from the values uploaded,
    on the host."""
    starts, m = starts_m
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    with span(ONESHOT_UPLOAD):
        m_t = torch.from_numpy(np.ascontiguousarray(m.transpose(0, 2, 1),
                                                    dtype=np_dtype))
        bands = general.band_table(m_t)
        return (torch.as_tensor(starts, dtype=torch.int64, device=device),
                m_t.to(device), bands.to(device),
                general.block_warpgroups(bands))


def _oneshot_aux(plan: EnginePlan, n: int, dtype: torch.dtype, device,
                 tier: str):
    """Host-prepared device arguments of the one-shot apply, at the
    resolved matmul tier ``tier`` (``precision.check_tier``; :func:`oneshot`
    reads it once per call).

    Every operator is designed (and cached) on the host and uploaded
    here, so that :func:`_oneshot_apply` is device work only.  The host
    caches hold float64 designs, the same at every tier; what is prepared
    for a tier (K1's limbs) is prepared here on each call, carries its
    tier, and is refused by a kernel call at another tier:

    - general and cubic: (starts, M, bands, warpgroups), the banded tile
      matrices (tens of MB per (plan, length)), their band table and the
      K3 block width for them;
    - rational: (R_t, Ipx, op, lam), the superframed per-period operator
      (the strict-antialias prefilter composed in, ``lam`` its context);
    - decimate: (R_t, Ipx, op, 0), the per-period matrix at the kernel's
      period on the card and the plain version's on the CPU; at
      ``DECIM_FFT_MIN_TAPS`` taps or more (spectrum,), the filter's
      ``fftstage.Spectrum``;
    - general with the strict-antialias prefilter: the general tuple
      followed by (h [1, taps], band), the prefilter's taps and, on the
      card, the banded convolution's operator for the padded input
      (``convolve.band_operator``; None on the CPU); at
      ``FFT_CONV_MIN_TAPS`` taps or more (spectrum, None), the
      prefilter's ``fftstage.Spectrum``;
    - dft_up: (coeffs, band), the prestage's polyphase rows and, on the
      card, the banded lowering's operator for the padded input
      (``convolve.band_operator``; None on the CPU); none at factor 1;
    - ``op`` is R_t as K1 reads it (``banded.prepare``) at ``tier``, None
      on the CPU.
    """
    check_tier(tier)
    device = torch.device(device)
    with span(ONESHOT_AUX):
        canonical = plan.lengths.canonical(n)
        if canonical <= 0 or n <= 0:
            return ()
        if plan.kind == 'cubic':
            with span(ONESHOT_DESIGN):
                mats = _cubic_matrices(plan, canonical)
            return _upload(mats, dtype, device)
        if plan.kind == 'dft_up':
            if plan.factor == 1:
                return ()
            with span(ONESHOT_UPLOAD):
                coeffs = torch.as_tensor(plan.pre_coeffs, dtype=dtype,
                                         device=device)
            if device.type != 'cuda':
                return coeffs, None
            # The prestage reads xext = (0^(T1-1) x 0^z), as _oneshot_apply
            # pads.
            n_ext = n + plan.pre_taps - 1 + plan.lengths.flush_pad(n)
            return coeffs, convolve.band_operator(coeffs, n_ext, 1, dtype,
                                                  device, tier)
        if plan.kind == 'decimate':
            if plan.decim_taps >= DECIM_FFT_MIN_TAPS:
                with span(ONESHOT_UPLOAD):
                    return (fftstage.spectrum(plan.decim_coeffs, dtype,
                                              device),)
            period = (PALLAS_DECIM_PERIOD if device.type == 'cuda'
                      else DECIM_PERIOD)
            with span(ONESHOT_DESIGN):
                r, _, ipx = _decim_matrix(plan, period)
            return _banded_aux(r, ipx, dtype, device, tier)
        # two_stage
        if plan.is_rational_exact:
            with span(ONESHOT_DESIGN):
                r, _, ipx, lam = _fused_rational_matrix(plan)
                r, ipx = superframe(r, ipx)
            return _banded_aux(r, ipx, dtype, device, tier, lam)
        with span(ONESHOT_DESIGN):
            mats = _general_matrices(plan, canonical)
        aux = _upload(mats, dtype, device)
        if not plan.aa_taps:
            return aux
        if plan.aa_taps >= FFT_CONV_MIN_TAPS:
            with span(ONESHOT_UPLOAD):
                return aux + (fftstage.spectrum(plan.aa_coeffs, dtype,
                                                device), None)
        with span(ONESHOT_UPLOAD):
            h = torch.as_tensor(plan.aa_coeffs, dtype=dtype,
                                device=device)[None, :]
        if device.type != 'cuda':
            return aux + (h, None)
        # The prefilter reads xext = (0^d x 0^(d+z)), as _oneshot_apply pads.
        n_ext = n + 2 * ((plan.aa_taps - 1) // 2) + plan.lengths.flush_pad(n)
        return aux + (h, convolve.band_operator(h, n_ext, 1, dtype, device,
                                                tier))


def _oneshot_apply(plan: EnginePlan, x: torch.Tensor, aux,
                   tier: str) -> torch.Tensor:
    """The device part of :func:`oneshot`: x [S, n] in its final dtype
    and device, ``aux`` from :func:`_oneshot_aux` for the same plan, n,
    dtype, device and resolved ``tier``."""
    check_tier(tier)
    with span(ONESHOT_APPLY):
        n = x.shape[1]
        lm = plan.lengths
        canonical = lm.canonical(n)
        if canonical <= 0 or n == 0:
            return x.new_zeros((x.shape[0], max(canonical, 0)))
        z = lm.flush_pad(n)

        if plan.kind == 'cubic':
            w_band = int(aux[1].shape[1])
            i_last = ((canonical - 1) * plan.cubic_step) >> CubicSim.FRAC_BITS
            histbuf = _pad(x, 3, max(0, i_last + w_band + 1 - (n + 3)))
            # Tile starts are <= the last window index; i_last bounds them.
            return _banded_tiles_apply(histbuf, aux, i_last, canonical, tier)

        if plan.kind == 'dft_up':
            if plan.factor == 1:
                return x  # unity ratio: pass-through (dft_stage.go:57-59)
            xext = _pad(x, plan.pre_taps - 1, z)
            u = prestage_apply(aux[0], xext, plan.factor, tier, band=aux[1])
            drop = lm.drop_prefix()
            return u[:, drop:drop + canonical]

        if plan.kind == 'decimate':
            # windows at j*M over (x 0^z ...): the canonical grid; K1
            # reads the zeros past x from nowhere (_banded_apply)
            if isinstance(aux[0], fftstage.Spectrum):
                need = (canonical - 1) * plan.factor + plan.decim_taps
                xs = _pad(x, 0, max(z, need - n))
                return fftstage._fft_decimate(plan, xs, canonical, aux[0])
            return _banded_apply(x, canonical, aux, tier)

        # two_stage
        if plan.is_rational_exact:
            return _banded_apply(x, canonical, aux, tier)
        if plan.aa_taps:
            # The strict-antialias prefilter: a delay-compensated 'same'
            # lowpass at the input rate, extended over the flush padding:
            # filter (x ++ 0^z), then continue with no further right padding.
            # Prototypes of FFT_CONV_MIN_TAPS taps or more: FFT overlap-save.
            d = (plan.aa_taps - 1) // 2
            h, band = aux[4:]
            xext = _pad(x, d, d + z)
            if isinstance(h, fftstage.Spectrum):
                x = fftstage.fft_correlate(xext, h, n + z)
            else:
                x = convolve.conv1d_poly(xext, h, stride=1, precision=tier,
                                         band=band)[:, 0, :]
            z = 0
        # The prestage is composed into the banded tile matrices (x domain);
        # the device never materializes the 2x intermediate stream.
        xext = _pad(x, plan.pre_taps - 1, z)
        return _poly_apply_general(plan, xext, canonical, aux, tier)


def _entry_tensor(x, dtype, device, name: str) -> torch.Tensor:
    """A one-shot entry point's input ``x`` [S, n] as a tensor on
    ``device`` in the compute dtype: float32 on the card, ``dtype`` (by
    default the input's) on the CPU.  Raises without a GPU for a CUDA
    device, for float64 on the card, and for another rank."""
    from .streaming import _torch_dtype

    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    if len(np.shape(x)) != 2:
        raise ValueError(
            f"{name} expects [streams, samples], got {tuple(np.shape(x))}")
    if dtype is None:
        dtype = torch.float32 if device.type == 'cuda' else (
            x.dtype if isinstance(x, torch.Tensor) else np.asarray(x).dtype)
    dtype = _torch_dtype(dtype)
    if device.type == 'cuda' and dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernels take float32; float64 "
                         "runs on device='cpu'")
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def oneshot(plan: EnginePlan, x, dtype=None, device='cuda') -> torch.Tensor:
    """Resample x [S, n] -> y [S, canonical(n)] in one call.

    Equivalent to the reference's Process+Flush one-shot stream
    (convenience.go:204-229).  ``x`` is a numpy array or a tensor; the
    result is a tensor on ``device``: float32 on the card (the type its
    kernels take), float32 or float64 on the CPU (``dtype``, by default
    the input's).  Without a GPU the default ``device='cuda'`` raises;
    pass ``device='cpu'`` to run the kernels' plain versions.  float32
    products run at the process-wide tier ``GAR_TPU_MATMUL_PRECISION``
    (default 'highest'), read once per call; float64 is exact.
    """
    x = _entry_tensor(x, dtype, device, "oneshot")
    tier = dot_precision(None)
    aux = _oneshot_aux(plan, int(x.shape[1]), x.dtype, x.device, tier)
    return _oneshot_apply(plan, x, aux, tier)
