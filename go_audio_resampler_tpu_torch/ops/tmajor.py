"""Time-major fused banded resampling (K2): the CUDA kernel and its plain
version.

Counterpart of the JAX package's ``ops/pallas_fused.py`` for its
time-major kernel ``fused_resample_tmajor``:

    yT[m*P2 + r, s] = sum_w xT[m*Ipx + w, s] * r[r, w]

``fused_resample_tmajor`` launches the hand-written kernel in
``csrc/fused_resample_tmajor.cu`` (built at first use, see ``_build``) for
CUDA tensors, and computes the plain version for CPU tensors.  There is no
fallback: a CUDA tensor the kernel does not take raises.  The kernel runs
K1's tile product and reads R as ``banded.prepare`` lays out R_t = r.T
(the same prepared operator serves K1 and K2), passed as ``op``, at
the product's precision tier (``ops/precision.py``), as K1 does.

The TPU module's ``kf`` (frames per grid step), ``choose_tmajor_tile``,
``choose_tmajor_kf`` and ``tmajor_vmem_bytes`` only size TPU tiles to its
scoped VMEM and have no counterpart: the CUDA kernel runs 256 or 128
streams of one frame (``banded.tile_rows``) times 80 output rows per
block and masks the ragged edges itself, whatever the frame and stream
counts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.spans import K2, span
from . import _build
from .banded import BandedOperator, resolve
from .precision import TIER_CODES, check_tier, tiered_matmul

#: Kernel launches so far (a plain integer; callers may reset it to 0).
launches = 0

_SOURCE = "fused_resample_tmajor"


def fused_resample_tmajor_reference(xt: torch.Tensor, r: torch.Tensor, *,
                                    ipx: int, wx: int, p2: int,
                                    n_frames: int,
                                    tier: str
                                    ) -> torch.Tensor:
    """Plain version: frames as an ``unfold`` along time, then ``matmul``
    at ``tier`` (``precision.tiered_matmul``).

    Computes in ``xt``'s dtype.  On a CUDA tensor a float32 ``matmul``
    follows ``torch.backends.cuda.matmul.allow_tf32``; callers that use
    this as the oracle on the card set it to False.
    """
    s = xt.shape[1]
    if n_frames == 0:
        return xt.new_zeros((0, s))
    need = (n_frames - 1) * ipx + wx
    frames = xt[:need].unfold(0, wx, ipx)                # [F, S, Wx]
    y = tiered_matmul(r.to(xt.dtype), frames.transpose(1, 2),
                      tier)                                   # [F, P2, S]
    return y.reshape(n_frames * p2, s)


def _check(xt, r, ipx, wx, p2, n_frames):
    if xt.dim() != 2 or r.dim() != 2:
        raise ValueError("fused_resample_tmajor: xt [n, S] and r [p2, wx] "
                         f"expected, got {tuple(xt.shape)} and "
                         f"{tuple(r.shape)}")
    if tuple(r.shape) != (p2, wx):
        raise ValueError(f"fused_resample_tmajor: r is {tuple(r.shape)}, "
                         f"expected ({p2}, {wx})")
    if ipx <= 0 or n_frames < 0:
        raise ValueError(
            f"fused_resample_tmajor: ipx={ipx}, n_frames={n_frames}")
    need = (n_frames - 1) * ipx + wx
    if n_frames and xt.shape[0] < need:
        raise ValueError(
            f"fused_resample_tmajor: {n_frames} frames need xt.shape[0] >= "
            f"(n_frames-1)*ipx + wx = {need}, got {xt.shape[0]}")


def fused_resample_tmajor(xt: torch.Tensor, r: torch.Tensor, *, ipx: int,
                          wx: int, p2: int, n_frames: int,
                          op: BandedOperator | None = None,
                          tier: str) -> torch.Tensor:
    """yT [n_frames*p2, S] with yT[m*p2 + r_, s] = sum_w r[r_, w] *
    xT[m*ipx + w, s], at the resolved matmul tier ``tier``.

    CUDA tensors go to the kernel, which takes contiguous float32 ``xt``
    and ``r`` on one device and raises on anything else; CPU tensors get
    :func:`fused_resample_tmajor_reference`.  ``op`` is
    ``banded.prepare(r.T, tier)``, built once with the operator; a CUDA
    call requires it, at the call's tier, and the plain version does not
    read it.
    """
    global launches
    _check(xt, r, ipx, wx, p2, n_frames)
    check_tier(tier)
    with span(K2):
        if xt.device.type == "cpu" and r.device.type == "cpu":
            return fused_resample_tmajor_reference(
                xt, r, ipx=ipx, wx=wx, p2=p2, n_frames=n_frames, tier=tier)
        if xt.device.type != "cuda" or r.device != xt.device:
            raise ValueError(f"fused_resample_tmajor: xt on {xt.device} and "
                             f"r on {r.device}; both must be on one CUDA "
                             "device (or both on the CPU)")
        if xt.dtype != torch.float32 or r.dtype != torch.float32:
            raise TypeError(f"fused_resample_tmajor: the CUDA kernel takes "
                            f"float32, got xt {xt.dtype} and r {r.dtype}")
        if not (xt.is_contiguous() and r.is_contiguous()):
            raise ValueError(
                "fused_resample_tmajor: xt and r must be contiguous")
        s = xt.shape[1]
        y = torch.empty((n_frames * p2, s), dtype=torch.float32,
                        device=xt.device)
        if y.numel() == 0:
            return y
        op = resolve(op, r.t(), "fused_resample_tmajor", tier)
        fn = _launcher()
        with torch.cuda.device(xt.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(xt.data_ptr(), xt.stride(0), op.packed.data_ptr(),
                     op.bands.data_ptr(), y.data_ptr(), n_frames, s, ipx, wx,
                     p2, op.split, TIER_CODES[tier], stream)
        if err:
            raise RuntimeError(
                f"fused_resample_tmajor: kernel launch failed with CUDA "
                f"error {err} (S={s}, n_frames={n_frames}, ipx={ipx}, "
                f"wx={wx}, p2={p2}, tier={tier})")
        launches += 1
        return y


@functools.cache
def _launcher():
    """The kernel's C launcher with its ctypes signature (built once)."""
    fn = _build.load(_SOURCE).fused_resample_tmajor_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn
