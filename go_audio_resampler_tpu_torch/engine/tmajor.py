"""Time-major device serving: [samples, streams] tensors.

PyTorch counterpart of the JAX package's ``engine/tmajor.py``.  Stored
time-major, a frame's window is a contiguous slab of rows and the fused
step becomes R [P2, Wx] @ slab [Wx, S] per frame: the K2 kernel
(``ops/tmajor.py``) on the card, its plain version on the CPU.
Interleaved multi-channel audio is [samples, channels] already, so an
ingest pipeline that holds interleaved frames needs no transpose.

Device-resident serving only (``process_device``/``flush_device``, the
twins of ``EngineCore``'s); the host-FIFO paths stay on the stream-major
engine.  The engine borrows ``EngineCore``'s constants (operator,
superframe, carry and drop arithmetic, length model) and its emit and
drain (``streaming._CanonicalStream``), and swaps only the step's layout,
so output rows equal ``EngineCore``'s output columns for the same plan.
"""

from __future__ import annotations

import torch

from ..ops import tmajor
from ..ops.precision import dispatch_for
from .plan import EnginePlan
from .streaming import EngineCore, _CanonicalStream, _ceil_div, _torch_dtype


def _step_banded_tmajor(r, carry, x, ipx, wx, p2, op=None, dispatch='auto',
                        *, tier):
    """Time-major twin of the fused banded step: [C+B, S] rows -> frames.

    ``r`` [P2, Wx] (not transposed: it is the left operand here), ``op``
    its prepared form on the card (``banded.prepare(r.T, tier)``); the
    step runs K2 where the gate lets ``dispatch`` through
    (``precision.dispatch_for``), else K2's plain version, at ``tier``;
    ``carry`` [C, S]; ``x`` [B, S] with B % ipx == 0.  Window j reads rows
    [carry ++ x][j*ipx : j*ipx + wx], the same canonical grid as the
    stream-major step.  Emits exactly (B/ipx)*P2 rows; the new carry is
    the last C rows of [carry ++ x], a contiguous view (no copy).
    """
    b = x.shape[0]
    n_frames = b // ipx
    data = torch.cat([carry.to(x.dtype), x], dim=0)
    kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=n_frames, tier=tier)
    if dispatch_for(dispatch, tier):
        y = tmajor.fused_resample_tmajor(data, r, op=op, **kw)
    else:
        y = tmajor.fused_resample_tmajor_reference(data, r, **kw)
    return data[b:], y, n_frames * p2


class TimeMajorEngine(_CanonicalStream):
    """Device-resident streaming resampler over time-major tensors.

    ``process_device(xt)`` takes [samples, streams] rows whose count is a
    multiple of :attr:`chunk_multiple` and returns the resampled
    [out_samples, streams] tensor on the engine's device with no host
    synchronization (static output counts).  ``flush_device`` drains the
    exact canonical tail.

    Supported topologies: the fused banded steps with static counts and
    no aperiodic head, i.e. exact-rational two-stage (with the
    strict-antialias prefilter composed in, where the plan has one),
    integer decimation and head-free banded composites
    (``pipeline.fused.BandedPlan``).  ``dft_up``, cubic and the non-exact
    walk are not fused banded steps and raise, as do composites with a
    head (``EngineCore`` runs them) and the FFT-routed decimation (no
    banded matrix; ``EngineCore`` runs it).  ``device`` is 'cuda' by default (K2);
    ``device='cpu'`` runs K2's plain version.
    ``dispatch`` and ``precision`` are ``EngineCore``'s: the same gate and
    the same tier, so the output equals ``EngineCore``'s.  With
    ``dispatch='tune'`` the inner ``EngineCore`` measures its stream-major
    step (K1 against its plain version) and its pin governs K2, as the
    JAX engine takes its inner engine's pin.
    """

    def __init__(self, plan: EnginePlan, batch: int = 1, block: int = 2048,
                 dtype=torch.float32, dispatch: str = 'auto',
                 precision: str = 'auto', device='cuda'):
        if plan.kind in ('dft_up', 'cubic') or (
                plan.kind == 'two_stage' and not plan.is_rational_exact):
            raise NotImplementedError(
                f"TimeMajorEngine: topology {plan.kind!r} is not a fused "
                "banded step; use EngineCore")
        if plan.kind == 'banded' and plan.op.head is not None:
            raise NotImplementedError(
                "TimeMajorEngine: banded composites with an aperiodic "
                "head are not supported; use EngineCore.process_device")
        # Borrow EngineCore's constants (the operator, carry, ipx, wx and
        # p2 of every fused banded step, composites included, the ramp drop
        # and the flush bound), its checks of the knobs and its resolved
        # dispatch.
        eng = EngineCore(plan, batch=batch, block=block, dtype=dtype,
                         dispatch=dispatch, precision=precision,
                         device=device)
        if eng._band is None:
            raise NotImplementedError(
                "TimeMajorEngine: FFT-routed decimation has no banded "
                "matrix; use EngineCore")
        self.plan = plan
        self.batch = batch
        self.dtype = _torch_dtype(dtype)
        self.device = eng.device
        self.block = eng.block
        self.dispatch = eng.dispatch
        self.precision = eng.precision
        self._tier = eng._tier
        (r_t, self._ipx, self._wx, self._p2, self._carry_len,
         self._op) = eng._band
        self._r = r_t.t().contiguous()          # [P2, Wx], left operand
        self._drop, self._flush_limit = eng._drop, eng._flush_limit
        self.reset()

    @property
    def chunk_multiple(self) -> int:
        """Row granularity of :meth:`process_device` chunks."""
        return self._ipx

    def reset(self) -> None:
        super().reset()
        self._carry = torch.zeros((self._carry_len, self.batch),
                                  dtype=self.dtype, device=self.device)

    def _zeros(self, rows: int) -> torch.Tensor:
        return torch.zeros((rows, self.batch), dtype=self.dtype,
                           device=self.device)

    def _run(self, xt: torch.Tensor) -> tuple[torch.Tensor, int]:
        self._carry, y, n_out = _step_banded_tmajor(
            self._r, self._carry, xt, ipx=self._ipx, wx=self._wx,
            p2=self._p2, op=self._op, dispatch=self.dispatch,
            tier=self._tier)
        return y, n_out

    def process_device(self, xt) -> torch.Tensor:
        """[n, S] rows in -> [m, S] rows out on the device, no syncs."""
        if self._flushed:
            raise RuntimeError("process after flush; call reset() first")
        xt = torch.as_tensor(xt, dtype=self.dtype, device=self.device)
        if xt.dim() != 2 or xt.shape[1] != self.batch:
            raise ValueError(f"expected [n, {self.batch}] time-major rows, "
                             f"got {tuple(xt.shape)}")
        n = int(xt.shape[0])
        if n % self._ipx:
            raise ValueError(f"chunk rows {n} not a multiple of "
                             f"chunk_multiple={self._ipx}")
        if n == 0:
            return self._zeros(0)
        self.samples_in += n
        return self._emit(*self._run(xt), None, axis=0)

    def flush_device(self) -> torch.Tensor:
        """Drain the canonical tail (``EngineCore.flush_device`` twin)."""
        def tail(z):
            if z:
                yield self._run(self._zeros(_ceil_div(z, self._ipx)
                                            * self._ipx))

        outs = self._drain(tail, lambda: self._run(self._zeros(self.block)),
                           axis=0)
        return torch.cat(outs, dim=0) if outs else self._zeros(0)
