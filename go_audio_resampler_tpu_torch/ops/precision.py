"""The matmul precision tiers of the kernels, and their dispatch gate.

Counterpart of the JAX package's ``ops/pallas_fused.py:60-148`` and
``:558-611``:

- ``PRECISION_MODES`` (:77) and :func:`dot_precision` (:80): the tier
  names; ``None`` or ``'auto'`` reads ``GAR_TPU_MATMUL_PRECISION`` at call
  time (default ``'highest'``, case-insensitive), an unknown name raises
  ``KeyError``.  Where the JAX function returns a ``lax.Precision``, this
  one returns the tier's name.
- :func:`bf16_round`, :func:`split_bf16` and :func:`tiered_matmul`: the
  limb split and the tiered product of ``mxu_dot`` (:95-125), in plain
  PyTorch; the kernels' plain versions compute their products with it.
  :func:`default_error_bound`: how far a ``'default'`` product may lie from
  the exact one.
- ``DISPATCH_MODES`` (:128), :func:`dispatch_for` (:131),
  :class:`force_xla` (:565) and :func:`dispatch_allowed` (:583): may a
  call site launch its hand-written kernel?

What a tier computes, on float32 operands (float64 is exact at every
tier, as the JAX package routes only float32 through its kernels):

- ``'highest'``: float32-accurate; the kernels run three TF32 passes.
- ``'high'``: ``hi(a)·hi(b) + (hi(a)·lo(b) + lo(a)·hi(b))`` with bf16
  limbs ``hi = bf16(x)`` (to nearest, ties to even) and ``lo = bf16(x -
  hi)``, float32 accumulation: about 2^-17 relative.
- ``'default'``: ``bf16(a)·bf16(b)``, float32 accumulation, the TPU's one
  pass: about 2^-9 relative.

A product of two bf16 values is exact in float32, so a kernel and its
plain version form the same products at every tier and differ only in the
order of their sums.

The entry points (``EngineCore``, ``TimeMajorEngine``, ``oneshot``,
``convolve.conv1d_poly``) resolve the tier once with :func:`dot_precision`;
everything below them takes that resolved tier as a required argument
(:func:`check_tier`) and never reads the process-wide variable.

The gate.  ``'auto'`` and ``'pallas'`` launch the kernel at every tier on
CUDA tensors; ``'xla'``, and any call inside :class:`force_xla`, run the
plain PyTorch version (the name keeps the JAX package's).  The JAX
package closes ``'auto'`` at ``'high'`` after an A/B on its TPU; that
measurement does not carry over to the GPU, so here the gate stays open.
CPU tensors take the plain version whatever the mode.
"""

from __future__ import annotations

import os

import torch

#: Per-engine tier names: 'auto' defers to the process-wide variable.
PRECISION_MODES = ('auto', 'highest', 'high', 'default')
#: The tiers themselves.
TIERS = ('highest', 'high', 'default')
#: The process-wide tier, read at call time.
ENV_VAR = 'GAR_TPU_MATMUL_PRECISION'
#: Each tier's code in the kernels' C interface (``banded_mma.cuh``).
TIER_CODES = {'highest': 0, 'high': 1, 'default': 2}
#: Per-engine lowering choices.
DISPATCH_MODES = ('auto', 'pallas', 'xla')


def dot_precision(tier: str | None = None) -> str:
    """The tier of a product: ``tier`` where it names one, else the
    process-wide ``GAR_TPU_MATMUL_PRECISION`` (default ``'highest'``),
    read now.  Case-insensitive; an unknown name raises ``KeyError``."""
    if tier is not None and tier != 'auto':
        name = tier.lower()
    else:
        name = os.environ.get(ENV_VAR, 'highest').lower()
    if name not in TIERS:
        raise KeyError(name)
    return name


def check_tier(tier: str) -> str:
    """``tier`` where it is one of TIERS, an already-resolved tier; anything
    else (``'auto'`` and None included) raises ``ValueError``."""
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS} (an entry point "
                         f"resolves 'auto' with dot_precision), got {tier!r}")
    return tier


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to bf16 (to nearest, ties to even), as
    float32 values."""
    if t.dtype != torch.float32:
        raise TypeError(f"bf16_round takes float32, got {t.dtype}")
    return t.to(torch.bfloat16).to(torch.float32)


def split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): the bf16 limbs of float32 ``t``, as float32 values:
    ``hi = bf16(t)``, ``lo = bf16(t - hi)``."""
    hi = bf16_round(t)
    return hi, bf16_round(t - hi)


def tiered_matmul(a: torch.Tensor, b: torch.Tensor, tier: str,
                  product=torch.matmul) -> torch.Tensor:
    """``product(a, b)`` at the resolved ``tier`` (:func:`check_tier`);
    ``product`` is a bilinear function, ``torch.matmul`` by default (an
    ``einsum`` also serves).

    At ``'highest'``, and for anything but two float32 operands, this is
    ``product(a, b)`` itself.  At ``'high'`` and ``'default'`` the bf16
    products are taken in float32 on bf16-valued float32 tensors: a
    product of bf16 tensors would round its output to bf16.  On a CUDA
    tensor the float32 products follow
    ``torch.backends.cuda.matmul.allow_tf32``, which an oracle sets to
    False.
    """
    check_tier(tier)
    if (tier == 'highest' or a.dtype != torch.float32
            or b.dtype != torch.float32):
        return product(a, b)
    if tier == 'default':
        return product(bf16_round(a), bf16_round(b))
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return product(a_hi, b_hi) + (product(a_hi, b_lo) + product(a_lo, b_hi))


def default_error_bound(x_abs_max: float, r_t) -> float:
    """Bound on |``'default'`` - exact| of products of signal samples up to
    ``x_abs_max`` with the columns of ``r_t`` [taps, columns] (a tensor or
    an array): both operands round to bf16 (2^-9 relative), so a product
    is off by at most (1 + 2^-9)^2 - 1 < 2^-8 * 1.001 of |a*b| and a sum by
    that share of max|x| * max_col sum|r_t|, plus 1e-6 of it for float32
    sums.  (``'high'`` is held to 3e-4 of max|y| instead, the JAX
    package's bound.)"""
    l1 = float(torch.as_tensor(r_t).double().abs().sum(dim=0).max())
    return (2.0 ** -8 * 1.001 + 1e-6) * x_abs_max * l1


#: When > 0, every gate routes to the plain version (see force_xla).
_FORCE_XLA_DEPTH = 0


class force_xla:
    """Context manager: inside it, every call site takes the plain
    PyTorch version instead of its kernel.  Re-entrant.  (The JAX package
    traces its functional backward through it; the port's will run it.)
    """

    def __enter__(self):
        global _FORCE_XLA_DEPTH
        _FORCE_XLA_DEPTH += 1
        return self

    def __exit__(self, *exc):
        global _FORCE_XLA_DEPTH
        _FORCE_XLA_DEPTH -= 1
        return False


def dispatch_allowed(tier: str | None = None) -> bool:
    """May a call site at ``tier`` launch its kernel?  Yes at every tier,
    unless inside :class:`force_xla`.  ``tier`` is checked as
    :func:`dot_precision` checks it."""
    dot_precision(tier)
    return _FORCE_XLA_DEPTH == 0


def dispatch_for(mode: str, tier: str | None = None) -> bool:
    """Per-call-site dispatch: ``'xla'`` takes the plain version,
    ``'auto'`` and ``'pallas'`` the kernel (:func:`dispatch_allowed`)."""
    if mode not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, got "
                         f"{mode!r}")
    if mode == 'xla':
        return False
    return dispatch_allowed(tier)
