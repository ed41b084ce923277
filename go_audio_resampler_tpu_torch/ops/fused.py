"""Fused banded resampling (K1): the CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/pallas_fused.py`` for its stream-
major kernel ``fused_resample_pallas``:

    y[s, m*P2 + r] = sum_w data[s, m*Ipx + w] * r_t[w, r]

``fused_resample`` launches the hand-written kernel in
``csrc/fused_resample.cu`` (built at first use, see ``_build``) for CUDA
tensors, and computes the plain version for CPU tensors.  There is no
fallback: a CUDA tensor the kernel does not take raises.  The kernel reads
R as ``banded.prepare`` lays it out (TF32 limbs and band table), which the
callers build once with their operator and pass as ``op``.

Both take the product's precision tier (``ops/precision.py``): the plain
version forms its products with ``precision.tiered_matmul``, the kernel
with the tier's tensor-core passes on R's limbs of the same tier.

The TPU module's tile helpers (``frame_tile_for``, ``choose_stream_tile``,
``vmem_bytes``) have no counterpart: the CUDA kernel tiles the flattened
(stream, frame) axis in blocks of 256 or 128 rows and 80 columns and
masks the ragged edges itself, whatever the frame count; its choices, the
cluster split of long bands and with it the block's rows, follow from the
operator (``banded.tile_rows``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.spans import K1, span
from . import _build
from .banded import BandedOperator, resolve
from .frames import gather_windows
from .precision import TIER_CODES, check_tier, tiered_matmul

#: Kernel launches so far (a plain integer; callers may reset it to 0).
launches = 0

_SOURCE = "fused_resample"


def fused_resample_reference(data: torch.Tensor, r_t: torch.Tensor, *,
                             ipx: int, wx: int, p2: int,
                             n_frames: int,
                             tier: str) -> torch.Tensor:
    """Plain version: frames as an ``unfold`` view, then one ``matmul``
    at ``tier`` (``precision.tiered_matmul``).

    Computes in ``data``'s dtype.  On a CUDA tensor a float32 ``matmul``
    follows ``torch.backends.cuda.matmul.allow_tf32``; callers that use
    this as the oracle on the card set it to False.
    """
    s = data.shape[0]
    if n_frames == 0:
        return data.new_zeros((s, 0))
    frames = gather_windows(data, n_frames, ipx, wx)      # [S, F, Wx]
    y = tiered_matmul(frames, r_t.to(data.dtype), tier)    # [S, F, P2]
    return y.reshape(s, n_frames * p2)


def _check(data, r_t, ipx, wx, p2, n_frames):
    if data.dim() != 2 or r_t.dim() != 2:
        raise ValueError("fused_resample: data [S, n] and r_t [wx, p2] "
                         f"expected, got {tuple(data.shape)} and "
                         f"{tuple(r_t.shape)}")
    if tuple(r_t.shape) != (wx, p2):
        raise ValueError(f"fused_resample: r_t is {tuple(r_t.shape)}, "
                         f"expected ({wx}, {p2})")
    if ipx <= 0 or n_frames < 0:
        raise ValueError(f"fused_resample: ipx={ipx}, n_frames={n_frames}")
    need = (n_frames - 1) * ipx + wx
    if n_frames and data.shape[1] < need:
        raise ValueError(
            f"fused_resample: {n_frames} frames need data.shape[1] >= "
            f"(n_frames-1)*ipx + wx = {need}, got {data.shape[1]}")


def fused_resample(data: torch.Tensor, r_t: torch.Tensor, *, ipx: int,
                   wx: int, p2: int, n_frames: int,
                   op: BandedOperator | None = None,
                   tier: str) -> torch.Tensor:
    """y [S, n_frames*p2] with y[s, m*p2 + r] = sum_w data[s, m*ipx + w] *
    r_t[w, r], at the resolved matmul tier ``tier``
    (``precision.check_tier``).

    CUDA tensors go to the kernel, which takes contiguous float32 ``data``
    and ``r_t`` on one device and raises on anything else; CPU tensors get
    :func:`fused_resample_reference`.  ``op`` is ``banded.prepare(r_t,
    tier)``, built once with the operator; a CUDA call requires it, at the
    call's tier, and the plain version does not read it.
    """
    global launches
    _check(data, r_t, ipx, wx, p2, n_frames)
    check_tier(tier)
    with span(K1):
        if data.device.type == "cpu" and r_t.device.type == "cpu":
            return fused_resample_reference(data, r_t, ipx=ipx, wx=wx, p2=p2,
                                            n_frames=n_frames, tier=tier)
        if data.device.type != "cuda" or r_t.device != data.device:
            raise ValueError(f"fused_resample: data on {data.device} and r_t "
                             f"on {r_t.device}; both must be on one CUDA "
                             "device (or both on the CPU)")
        if data.dtype != torch.float32 or r_t.dtype != torch.float32:
            raise TypeError(f"fused_resample: the CUDA kernel takes float32, "
                            f"got data {data.dtype} and r_t {r_t.dtype}")
        if not (data.is_contiguous() and r_t.is_contiguous()):
            raise ValueError("fused_resample: data and r_t must be contiguous")
        s = data.shape[0]
        y = torch.empty((s, n_frames * p2), dtype=torch.float32,
                        device=data.device)
        if y.numel() == 0:
            return y
        op = resolve(op, r_t, "fused_resample", tier)
        fn = _launcher()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(data.data_ptr(), data.stride(0), op.packed.data_ptr(),
                     op.bands.data_ptr(), y.data_ptr(), s * n_frames,
                     n_frames, ipx, wx, p2, op.split, TIER_CODES[tier],
                     stream)
        if err:
            raise RuntimeError(f"fused_resample: kernel launch failed with "
                               f"CUDA error {err} (S={s}, "
                               f"n_frames={n_frames}, ipx={ipx}, wx={wx}, "
                               f"p2={p2}, tier={tier})")
        launches += 1
        return y


@functools.cache
def _launcher():
    """The kernel's C launcher with its ctypes signature (built once)."""
    fn = _build.load(_SOURCE).fused_resample_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn
