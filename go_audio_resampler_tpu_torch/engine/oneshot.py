"""Banded-operator builders shared by the one-shot and streaming paths.

This slice of the port carries only what the streaming engine's fused
exact-rational step needs: ``superframe`` and ``_fused_rational_matrix``
with its cache.  Both are float64 numpy copies of the JAX package's
functions and return bit-equal arrays.  The one-shot entry point itself
is not ported yet (ROADMAP.md, queue 1 item 7).
"""

from __future__ import annotations

import math

import numpy as np

from ..filterdesign.params import PHASE_FRAC_BITS
from .plan import EnginePlan


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

    Returns (R [P2, Wx], P2 outputs/period, Ipx input samples/period,
    lam left zero-context).  Computed once per plan in float64 and cached.

    Plans with the strict-antialias prefilter (``aa_taps > 0``) need the
    operator composition of ``pipeline/fused.compose``, which is not
    ported yet: they raise NotImplementedError.
    """
    if plan.aa_taps:
        raise NotImplementedError(
            "strict-antialias plans (aa_taps > 0) need pipeline/fused."
            "compose, not ported yet (ROADMAP.md, queue 1 item 2)")
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
    _FUSED_CACHE[key] = (R, P2, Ipx, 0)
    return _FUSED_CACHE[key]
