"""Whole-pipeline fusion: collapse a stage chain into one banded operator.

Counterpart of the JAX package's ``pipeline/fused.py`` (host numpy,
float64, bit-equal to it).  Every planned stage (half-band up/down,
integer decimation, exact-rational polyphase, strict-antialias prefilter)
is a periodically time-varying banded linear operator, and the
composition of such operators is again one.  So a chain of stages
collapses on the host into a single ``[P, W]`` per-period matrix that
streams through the fused banded step of ``EngineCore`` (the K1 kernel on
the card) or ``TimeMajorEngine`` (K2).

Normal form (``BandedOp``): with ``xe = zeros(lam) ++ x ++ zeros(...)``,

    y[m*P + r] = dot(R[r], xe[m*I : m*I + W])

and the canonical output count of the stage is ``count(n)`` (the exact
reference Process+Flush count, from the per-stage LengthModel).  The
composition is exact, not approximate: each stage's post-canonical
outputs are identically zero in the infinite-zero-padded extension (the
canonical count is precisely "windows that end within the flush
padding", so the first non-emitted window already lies entirely in
zeros).

Reference anchors: the stage chain replaced (constant.go:255-293), the
planner stages realized (stages.go:21-119), flush tail propagation
subsumed (constant.go:349-389).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..engine.counts import LengthModel
from ..engine.plan import EnginePlan

#: Composite band-width guard: beyond this the frames working set
#: (n_frames x W per stream) stops paying for itself; the chain is not
#: fused.  Generous: the deepest realistic audio chain (192k->8k VeryHigh:
#: 4 half-bands + residual) stays well under it.
MAX_FUSED_WIDTH = 65536


@dataclasses.dataclass
class BandedOp:
    """One periodic banded operator in the normal form above.

    ``head`` (optional) holds exact rows for a finite aperiodic startup
    region: when a downstream stage's left context (``lam`` > 0) reaches
    into an upstream stage's *truncated* output stream (the chain feeds
    zeros before sample 0, not the upstream filter's pre-ring), the first
    ``n_head`` composite outputs deviate from the periodic pattern.  Row k
    of ``head`` is the exact linear map of output k over
    ``xe = 0^lam ++ x``; outputs k >= n_head follow ``R`` exactly.
    """

    P: int                 # outputs per period
    I: int                 # input samples consumed per period
    W: int                 # window width
    R: np.ndarray          # [P, W] float64 per-period matrix
    lam: int               # left zero-context of the first window
    lengths: tuple         # per-stage LengthModels (for count folding)
    head: np.ndarray | None = None   # [n_head, W_head] exact startup rows

    @property
    def n_head(self) -> int:
        return 0 if self.head is None else self.head.shape[0]

    def count(self, n: int) -> int:
        """Canonical output count: fold of the stage chain's counts."""
        for lm in self.lengths:
            n = lm.canonical(n)
        return n

    @property
    def ratio(self) -> float:
        return self.P / self.I

    def apply(self, x: np.ndarray, count: int | None = None) -> np.ndarray:
        """Reference numpy apply (float64), for tests and small inputs."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        n = x.shape[1]
        if count is None:
            count = self.count(n)
        if count <= 0:
            return np.zeros((x.shape[0], 0))
        n_per = -(-count // self.P)
        need = (n_per - 1) * self.I + self.W
        wh = self.head.shape[1] if self.head is not None else 0
        xe = np.zeros((x.shape[0], max(self.lam + need, n + self.lam, wh)))
        xe[:, self.lam:self.lam + n] = x
        idx = (np.arange(n_per)[:, None] * self.I
               + np.arange(self.W)[None, :])
        frames = xe[:, idx]                       # [S, n_per, W]
        y = np.einsum('sfw,pw->sfp', frames, self.R)
        y = y.reshape(x.shape[0], -1)[:, :count]
        if self.head is not None and count > 0:
            k1 = min(self.n_head, count)
            y[:, :k1] = xe[:, :wh] @ self.head[:k1].T
        return y


def banded_op_from_arrays(fields: dict) -> BandedOp:
    """Build a :class:`BandedOp` from another operator's fields.

    ``fields`` maps every ``BandedOp`` field name (``P, I, W, R, lam,
    lengths, head``) to its value, as read off an operator of the JAX
    package; its arrays are copied as float64 numpy and each of its
    ``lengths`` is rebuilt as this package's :class:`LengthModel`
    (``engine.plan.plan_from_arrays`` does the same for a plan).
    """
    kw = {}
    for f in dataclasses.fields(BandedOp):
        v = fields[f.name]
        if f.name == 'lengths':
            v = tuple(LengthModel(**{g.name: getattr(lm, g.name)
                                     for g in dataclasses.fields(LengthModel)})
                      for lm in v)
        elif f.name in ('R', 'head'):
            v = None if v is None else np.array(v, dtype=np.float64)
        else:
            v = int(v)
        kw[f.name] = v
    return BandedOp(**kw)


def banded_from_plan(plan: EnginePlan) -> BandedOp | None:
    """Express an engine plan as a BandedOp (None when not periodic).

    Covered: 'dft_up' (incl. the factor-1 pass-through), 'decimate',
    'two_stage' with an exact-rational walk (optionally with the
    strict-antialias prefilter composed in).  'cubic' and non-exact
    rational two-stage plans are not periodic operators.
    """
    lm = (plan.lengths,)
    if plan.kind == 'dft_up':
        if plan.factor == 1:
            return BandedOp(P=1, I=1, W=1, R=np.ones((1, 1)), lam=0,
                            lengths=lm)
        # canonical out j = m*F + p = dot(x[m : m+T1], pre_coeffs[p])
        return BandedOp(P=plan.factor, I=1, W=plan.pre_taps,
                        R=np.array(plan.pre_coeffs, dtype=np.float64),
                        lam=0, lengths=lm)
    if plan.kind == 'decimate':
        # canonical out j = dot((x ++ 0...)[j*M : j*M+T], decim_coeffs)
        return BandedOp(P=1, I=plan.factor, W=plan.decim_taps,
                        R=np.array(plan.decim_coeffs,
                                   dtype=np.float64)[None, :],
                        lam=0, lengths=lm)
    if plan.kind == 'two_stage' and plan.is_rational_exact:
        # The strict-antialias prefilter (when present) is already
        # composed into the matrix, reflected by lam > 0.
        from ..engine.oneshot import _fused_rational_matrix
        r, p2, ipx, lam = _fused_rational_matrix(plan)
        return BandedOp(P=p2, I=ipx, W=r.shape[1],
                        R=np.array(r, dtype=np.float64), lam=lam,
                        lengths=lm)
    return None


def compose(A: BandedOp, B: BandedOp) -> BandedOp:
    """Operator composition ``B o A`` (A first, then B), exact in float64.

    B reads A's canonical stream: output k = mB*PB + rB of the composite
    sums RB[rB, v] * yA[mB*IB + v - lamB], and each yA[j], j = mA*PA + rA,
    sums RA[rA, w] * x[mA*IA + w - lamA].  The composite period repeats
    every lcm-aligned k_rep = PA/gcd(IB, PA) periods of B.  Negative yA
    indices are B's virtual left zeros (skipped); negative x positions
    become the composite's left context ``lam``.
    """
    g = math.gcd(B.I, A.P)
    k_rep = A.P // g
    Pc = B.P * k_rep
    Ic = (k_rep * B.I // A.P) * A.I

    # Bounds of x positions relative to the composite frame start.  A
    # frame-0 tap with j < 0 (inside B's left context) uses FLOORED
    # division: its frame-relative position is negative, landing in the
    # composite's zero context for frame 0 while reading the right real
    # samples for later frames (position + m*Ic); the floor arithmetic
    # keeps both exact for every m.
    j_max = (k_rep - 1) * B.I + B.W - 1 - B.lam
    if j_max < 0:
        raise ValueError("composition consumes no input")
    j_min = -B.lam
    pos_min = (j_min // A.P) * A.I - A.lam
    pos_max = (j_max // A.P) * A.I - A.lam + A.W - 1
    lam_c = max(0, -pos_min)
    Wc = pos_max + lam_c + 1

    Rc = np.zeros((Pc, Wc), dtype=np.float64)
    for k in range(Pc):
        mB, rB = divmod(k, B.P)
        row = B.R[rB]
        for v in np.nonzero(row)[0]:
            j = mB * B.I + int(v) - B.lam
            mA, rA = divmod(j, A.P)      # floored for j < 0
            base = mA * A.I - A.lam + lam_c
            Rc[k, base:base + A.W] += row[v] * A.R[rA]

    # Aperiodic head: composite output k reads yA[j], j = (k//PB)*IB + v
    # - B.lam, and the periodic rows above assume the UPSTREAM pattern for
    # every j.  But the chain truncates: yA[j] = 0 for j < 0 (B's virtual
    # left zeros are true zeros, not A's pre-ring), and yA[j] follows A's
    # own head rows for j < A.n_head.  Both effects end once
    # (k//PB)*IB - B.lam >= A.n_head, so the first n_head outputs get
    # exact dedicated rows over xe = 0^lam_c ++ x.
    head_c = None
    if B.lam > 0 or A.n_head > 0:
        n_head = B.P * _ceil_div(A.n_head + B.lam, B.I)
        if n_head > 0:
            j_max_h = ((n_head - 1) // B.P) * B.I + B.W - 1 - B.lam
            reach = (j_max_h // A.P) * A.I - A.lam + A.W
            if A.head is not None:
                reach = max(reach, A.head.shape[1] - A.lam)
            w_head = lam_c + max(reach, 0)
            head_c = np.zeros((n_head, w_head), dtype=np.float64)
            shift = lam_c - A.lam
            for k in range(n_head):
                mB, rB = divmod(k, B.P)
                row = B.R[rB]
                for v in np.nonzero(row)[0]:
                    j = mB * B.I + int(v) - B.lam
                    if j < 0:
                        continue                    # true zeros
                    if j < A.n_head:
                        h = A.head[j]
                        head_c[k, shift:shift + len(h)] += row[v] * h
                    else:
                        mA, rA = divmod(j, A.P)
                        base = mA * A.I - A.lam + lam_c
                        head_c[k, base:base + A.W] += row[v] * A.R[rA]

    # Trim all-zero edge columns (keeps W tight; lam stays >= 0).  Leading
    # trim is skipped when a head exists (head rows share the lam origin).
    nz = np.nonzero(np.any(Rc != 0.0, axis=0))[0]
    if len(nz):
        lead = 0 if head_c is not None else min(int(nz[0]), lam_c)
        tail = int(nz[-1]) + 1
        Rc = Rc[:, lead:tail]
        lam_c -= lead
    return BandedOp(P=Pc, I=Ic, W=Rc.shape[1], R=Rc, lam=lam_c,
                    lengths=A.lengths + B.lengths, head=head_c)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def fuse_chain(plans) -> BandedOp | None:
    """Compose a list of engine plans into one BandedOp (or None).

    Returns None when any stage is not banded-representable, when the
    chain is empty, or when the composite band width exceeds
    MAX_FUSED_WIDTH.
    """
    ops = []
    for plan in plans:
        op = banded_from_plan(plan)
        if op is None:
            return None
        ops.append(op)
    if not ops:
        return None
    out = ops[0]
    for op in ops[1:]:
        out = compose(out, op)
        if out.W > MAX_FUSED_WIDTH:
            return None
    return out


class BandedLengthModel:
    """LengthModel facade for a composite BandedOp (EngineCore contract).

    ``canonical(n)`` folds the stage chain's exact counts;
    ``flush_pad(n)`` is the exact zero padding after which the last
    canonical window fits; ``drop_prefix()`` is 0 because the streaming
    wrapper drops via the banded carry override instead.
    """

    def __init__(self, op: BandedOp):
        self.op = op

    def canonical(self, n: int) -> int:
        return self.op.count(n)

    def flush_pad(self, n: int) -> int:
        if n <= 0:
            return 0
        can = self.canonical(n)
        if can <= 0:
            return 0
        m_last = -(-can // self.op.P) - 1
        return max(m_last * self.op.I - self.op.lam + self.op.W - n, 0)

    def drop_prefix(self) -> int:
        return 0


class BandedPlan:
    """Plan-shaped wrapper so EngineCore can stream a composite BandedOp.

    Provides the attributes EngineCore touches:
    ``kind``/``lengths``/``ratio``/``latency``/``estimate_output``.
    """

    kind = 'banded'

    def __init__(self, op: BandedOp, ratio: float, latency: int = 0):
        self.op = op
        self.ratio = float(ratio)
        self.lengths = BandedLengthModel(op)
        self._latency = int(latency)
        self.num_phases = op.P
        self.aa_taps = 0

    @property
    def fingerprint(self) -> tuple:
        """Stable identity for matrix caches and checkpoint validation.

        Includes a digest of the operator's coefficient content (R and the
        aperiodic head rows), mirroring EnginePlan.fingerprint: geometry
        alone (P/I/W/lam) cannot distinguish two composites with the same
        banded shape but different filters.
        """
        fp = getattr(self, '_fingerprint', None)
        if fp is None:
            import hashlib
            h = hashlib.blake2b(digest_size=16)
            h.update(np.ascontiguousarray(self.op.R).tobytes())
            h.update(b'|' if self.op.head is None else
                     np.ascontiguousarray(self.op.head).tobytes())
            fp = ('banded', self.op.P, self.op.I, self.op.W, self.op.lam,
                  float(self.ratio), h.hexdigest())
            self._fingerprint = fp
        return fp

    def latency(self) -> int:
        return self._latency

    def estimate_output(self, n_in: int) -> int:
        return int(n_in * self.ratio) + 64

    def filter_length(self) -> int:
        return int(np.count_nonzero(np.any(self.op.R != 0.0, axis=0)))

    def algorithm(self) -> str:
        return 'fused-banded-pipeline'
