"""Pure-functional resampling: a differentiable PyTorch op.

PyTorch counterpart of the JAX package's ``functional.py``.  The
reference is a stateful host library; its one-shot helpers
(convenience.go:204-229) run outside any autograd graph.  Here resampling
is a function of a tensor that a training step can call, with gradients
flowing back to a learned front end (e.g. 48k -> 16k ingest or
augmentation inside the step).

Semantics match the one-shot stream (``engine.oneshot``): for ``n``
input samples the output is the canonical ``ceil(n * ratio)`` samples of
the fully flushed stream, equal to ``convenience.resample_mono``.

Differentiation: resampling is a linear operator ``y = R x``, so the
vector-Jacobian product is the transposed operator ``x_bar = R^T y_bar``.
The forward pass takes the normal dispatch (the K1 kernel on the card);
the backward pass re-runs the operator through the kernels' plain
versions (``ops.precision.force_xla``) at a zero primal, under autograd,
and differentiates that: a hand-written kernel has no autograd rule.
Both directions use the same coefficients, so gradient checks hold to
machine precision.

Exact-rational, decimation and dft_up plans run the one-shot's per-period
operator (``_oneshot_aux`` with ``_oneshot_apply``: K1 on the card), so
their forward equals ``oneshot`` bit for bit.  Non-exact ratios and QUICK
cubic plans run a block loop of the streaming stage functions (the JAX
package's ``_scan_apply``: the prestage on K1, then the polyphase or
cubic walk), whose only constants are the coefficient banks, instead of
the one-shot's banded tile matrices, which scale with the audio length;
it equals the one-shot stream to float rounding (the tile product sums
in a different order).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .api import QualityPreset
from .convenience import preset_to_engine_quality
from .engine import plan_engine, stages
from .engine.oneshot import _oneshot_apply, _oneshot_aux, _pad
from .engine.plan import EnginePlan
from .engine.stages import CubicState, PolyState, PrestageState
from .engine.streaming import CAP_LIMIT, _torch_dtype
from .ops import convolve
from .ops.precision import dot_precision, force_xla
from .utils.spans import FUNCTIONAL_RESAMPLE, span


def _needs_length_matrices(plan: EnginePlan) -> bool:
    """Plans whose one-shot lowering builds per-length banded matrices."""
    return (plan.kind == 'cubic'
            or (plan.kind == 'two_stage' and not plan.is_rational_exact))


@functools.lru_cache(maxsize=16)
def _walk_constants(plan: EnginePlan, dtype: torch.dtype,
                    device: torch.device, tier: str) -> tuple:
    """The general walk's constants for :func:`_scan_apply`: (block, cap,
    hist, banks, prestage rows, the prestage's K1 operator on the card
    or None)."""
    block = 4096
    m = block * plan.factor
    cap = -(-(m * plan.num_phases * 65536) // plan.step) + 1
    while cap > CAP_LIMIT and block > 1:      # walk16 int32 bound
        block //= 2
        m = block * plan.factor
        cap = -(-(m * plan.num_phases * 65536) // plan.step) + 1
    if cap > CAP_LIMIT:
        # Unreachable for ratios within MAX_RATIO (cap ~ block*ratio),
        # but block==1 would otherwise divide by zero below.
        raise ValueError(
            f"polyphase walk cap {cap} exceeds the int32 bound even at "
            f"block=1 (ratio {plan.ratio}); ratio out of supported range")
    step_in = -(-plan.step // (plan.num_phases * 65536))
    hist = plan.poly_taps + step_in + 2 + m + plan.lengths.core_delta()
    banks = tuple(torch.as_tensor(b, dtype=dtype, device=device) for b in
                  (plan.bank_a, plan.bank_b, plan.bank_c, plan.bank_d))
    pre = torch.as_tensor(plan.pre_coeffs, dtype=dtype, device=device)
    band = (convolve.band_operator(pre, plan.pre_taps - 1 + block, 1, dtype,
                                   device, tier)
            if device.type == 'cuda' else None)
    return block, cap, hist, banks, pre, band


def _scan_apply(plan: EnginePlan, x: torch.Tensor, tier: str) -> torch.Tensor:
    """Canonical one-shot stream through a block loop of the streaming
    step.

    The functional path for non-exact-rational and cubic plans: the whole
    input (plus the exact flush padding and the holdback slack) streams
    through the per-block stage functions; each block's valid outputs
    (a host count) are concatenated and the stream cut to
    ``[drop : drop + canonical]``.  The constants are the compact
    coefficient banks, whatever the audio length.
    """
    s, n = x.shape
    lm = plan.lengths
    canonical = lm.canonical(n)
    if canonical <= 0 or n == 0:
        return x.new_zeros((s, max(canonical, 0)))
    drop = lm.drop_prefix()
    z = lm.flush_pad(n)

    if plan.kind == 'cubic':
        block = 4096
        cap = -(-(block << 32) // plan.cubic_step) + 1
        while cap > CAP_LIMIT and block > 1:      # walk32 int32 bound
            block //= 2
            cap = -(-(block << 32) // plan.cubic_step) + 1
        hold = 4
        state = CubicState(carry=x.new_zeros((s, 3)), at_int=0, at_f1=0,
                           at_f0=0)

        def step(st, xb):
            st, y, _valid, n_ = stages.cubic_process(st, xb, plan.cubic_step,
                                                     cap)
            return st, y[:, :n_]
    else:
        block, cap, hist, banks, pre, band = _walk_constants(
            plan, x.dtype, x.device, tier)
        hold = hist
        state = (PrestageState(carry=x.new_zeros((s, plan.pre_taps - 1))),
                 PolyState(hist=x.new_zeros((s, hist)), hist_len=0,
                           at_hi=plan.at0 >> 16, at_lo=plan.at0 & 0xFFFF))

        def step(st, xb):
            pre_st, poly = st
            pre_st, u = stages.prestage_process(pre, pre_st, xb, plan.factor,
                                                tier, band=band)
            poly, y, _valid, n_ = stages.poly_process(
                banks, poly, u, plan.num_phases, plan.poly_taps,
                plan.step_hi, plan.step_lo, cap, tier)
            return (pre_st, poly), y[:, :n_]

    k = -(-(n + z + hold) // block)
    xs = _pad(x, 0, k * block - n)
    ys = []
    for i in range(k):
        state, y = step(state, xs[:, i * block:(i + 1) * block])
        ys.append(y)
    out = torch.cat(ys, dim=1)
    bound = drop + canonical
    if out.shape[1] < bound:
        out = _pad(out, 0, bound - out.shape[1])
    return out[:, drop:bound]


@functools.lru_cache(maxsize=16)
def _aux(plan: EnginePlan, n: int, dtype: torch.dtype, device: torch.device,
         tier: str):
    """The one-shot's device arguments (``_oneshot_aux``), kept for
    repeated calls at one (plan, length, dtype, device, tier)."""
    return _oneshot_aux(plan, n, dtype, device, tier)


def _apply(plan: EnginePlan, x2: torch.Tensor, tier: str) -> torch.Tensor:
    if _needs_length_matrices(plan):
        return _scan_apply(plan, x2, tier)
    aux = _aux(plan, int(x2.shape[1]), x2.dtype, x2.device, tier)
    return _oneshot_apply(plan, x2, aux, tier)


def output_length(n: int, input_rate: float, output_rate: float,
                  quality: QualityPreset = QualityPreset.HIGH,
                  hq_interp: bool = False) -> int:
    """Canonical output length of ``resample`` for ``n`` input samples."""
    plan = _plan(float(input_rate), float(output_rate), quality, hq_interp)
    return max(plan.lengths.canonical(int(n)), 0)


@functools.lru_cache(maxsize=None)
def _plan(input_rate: float, output_rate: float,
          quality: QualityPreset, hq_interp: bool = False) -> EnginePlan:
    return plan_engine(input_rate, output_rate,
                       preset_to_engine_quality(quality),
                       hq_interp=hq_interp)


class _LinearOp(torch.autograd.Function):
    """y = R x with the exact transpose as its backward."""

    @staticmethod
    def forward(ctx, x2, plan, tier):
        ctx.plan, ctx.tier, ctx.n = plan, tier, int(x2.shape[1])
        return _apply(plan, x2, tier)

    @staticmethod
    def backward(ctx, ct):
        # The op is linear, so its vector-Jacobian product at any primal
        # point is the constant transposed operator; zeros is the cheapest
        # primal.  The plain versions (force_xla) carry autograd through.
        with force_xla(), torch.enable_grad():
            z = ct.new_zeros((ct.shape[0], ctx.n), requires_grad=True)
            y = _apply(ctx.plan, z, ctx.tier)
            (xbar,) = torch.autograd.grad(y, z, ct, allow_unused=True)
        if xbar is None:               # an empty output reads no input
            xbar = torch.zeros_like(z)
        return xbar, None, None


def resample(x, input_rate: float, output_rate: float, *,
             quality: QualityPreset = QualityPreset.HIGH,
             dtype=None, hq_interp: bool = False,
             device='cuda') -> torch.Tensor:
    """Resample the last axis of ``x``: differentiable.

    Args:
      x: ``[..., n]`` tensor or array (any leading batch axes; they are
        flattened into the stream axis and restored on output).
      input_rate / output_rate: sample rates.
      quality: a :class:`QualityPreset`.
      dtype: compute dtype: by default float32 on the card
        (``api.default_dtype``) and on the CPU ``x``'s dtype where it is
        float32 or float64, else float32; the card computes float32 only.
      hq_interp: (beyond reference) corrected phase-bank boundary + 8x
        denser banks for non-exact ratios; see api.Config.hq_interp.
      device: where the op runs and its result lives; ``'cuda'`` by
        default, which raises without a GPU (pass ``device='cpu'``).

    Returns:
      ``[..., m]`` with ``m = output_length(n, ...)``: the canonical
      fully-flushed one-shot stream, equal to ``convenience.resample_mono``
      per leading index, on ``device``, in ``x``'s dtype where that is a
      float type (else in the compute dtype).  float32 products run at
      the process-wide tier ``GAR_TPU_MATMUL_PRECISION``, read per call.
    """
    with span(FUNCTIONAL_RESAMPLE):
        plan = _plan(float(input_rate), float(output_rate), quality, hq_interp)
        x = torch.as_tensor(x)
        if x.dim() == 0:
            raise ValueError("resample expects at least one axis of samples")
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("resample: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        if dtype is None:
            # The card's type (api.default_dtype); on the CPU the input's
            # float type, as the JAX package takes it, else float32.
            dtype = (x.dtype if device.type == 'cpu'
                     and x.dtype in (torch.float32, torch.float64)
                     else torch.float32)
        dtype = _torch_dtype(dtype)
        if device.type == 'cuda' and dtype != torch.float32:
            raise ValueError("resample: the card computes float32; float64 "
                             "runs on device='cpu'")
        lead = tuple(x.shape[:-1])
        n = int(x.shape[-1])
        x2 = x.reshape((int(np.prod(lead, dtype=np.int64)) if lead else 1, n))
        y2 = _LinearOp.apply(x2.to(device=device, dtype=dtype), plan,
                             dot_precision(None))
        if x.is_floating_point():
            y2 = y2.to(x.dtype)
        return y2.reshape(lead + (y2.shape[-1],))
