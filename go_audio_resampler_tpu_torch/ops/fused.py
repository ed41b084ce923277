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

#: Of those, the launches that read a head or zeros past the data (the
#: virtual row's pieces in place); a plain integer, like ``launches``.
inplace_launches = 0

_SOURCE = "fused_resample"


def _head_width(head: torch.Tensor | int | None) -> int:
    if head is None:
        return 0
    return head if isinstance(head, int) else head.shape[1]


def virtual_row(data: torch.Tensor, head: torch.Tensor | int | None = None,
                width: int | None = None) -> torch.Tensor:
    """The rows K1 reads, materialised: ``head ++ data ++ zeros`` cut or
    zero-extended to ``width`` columns (by default the head's and the
    data's together).  ``head`` is an [S, C] tensor, or an int C for C
    zeros, or None.  Where no head and no zeros are asked for, returns a
    view of ``data``."""
    c = _head_width(head)
    n = data.shape[1]
    width = c + n if width is None else width
    if c == 0 and width <= n:
        return data[:, :width]
    parts = [data[:, :max(width - c, 0)]]
    if c:
        parts.insert(0, data.new_zeros((data.shape[0], c))
                     if isinstance(head, int) else head.to(data.dtype))
    if width > c + n:
        parts.append(data.new_zeros((data.shape[0], width - c - n)))
    return torch.cat(parts, dim=1)[:, :width]


def fused_resample_reference(data: torch.Tensor, r_t: torch.Tensor, *,
                             ipx: int, wx: int, p2: int,
                             n_frames: int,
                             tier: str,
                             head: torch.Tensor | int | None = None,
                             width: int | None = None) -> torch.Tensor:
    """Plain version: the virtual row materialised (:func:`virtual_row`),
    its frames as an ``unfold`` view, then one ``matmul`` at ``tier``
    (``precision.tiered_matmul``).

    Computes in ``data``'s dtype.  On a CUDA tensor a float32 ``matmul``
    follows ``torch.backends.cuda.matmul.allow_tf32``; callers that use
    this as the oracle on the card set it to False.
    """
    s = data.shape[0]
    if n_frames == 0:
        return data.new_zeros((s, 0))
    data = virtual_row(data, head, width)
    frames = gather_windows(data, n_frames, ipx, wx)      # [S, F, Wx]
    y = tiered_matmul(frames, r_t.to(data.dtype), tier)    # [S, F, P2]
    return y.reshape(s, n_frames * p2)


def _check(data, r_t, ipx, wx, p2, n_frames, head, width):
    if data.dim() != 2 or r_t.dim() != 2:
        raise ValueError("fused_resample: data [S, n] and r_t [wx, p2] "
                         f"expected, got {tuple(data.shape)} and "
                         f"{tuple(r_t.shape)}")
    if tuple(r_t.shape) != (wx, p2):
        raise ValueError(f"fused_resample: r_t is {tuple(r_t.shape)}, "
                         f"expected ({wx}, {p2})")
    if ipx <= 0 or n_frames < 0:
        raise ValueError(f"fused_resample: ipx={ipx}, n_frames={n_frames}")
    if isinstance(head, int):
        if head < 0:
            raise ValueError(f"fused_resample: a head of {head} zeros")
    elif head is not None and (head.dim() != 2
                               or head.shape[0] != data.shape[0]):
        raise ValueError(f"fused_resample: head {tuple(head.shape)} for "
                         f"data {tuple(data.shape)}; [S, C] expected")
    need = (n_frames - 1) * ipx + wx
    if head is None and width is None:
        name, have = "data.shape[1]", data.shape[1]
    else:
        name = "width"
        have = _head_width(head) + data.shape[1] if width is None else width
    if n_frames and have < need:
        raise ValueError(
            f"fused_resample: {n_frames} frames need {name} >= "
            f"(n_frames-1)*ipx + wx = {need}, got {have}")


def _rows(t: torch.Tensor) -> bool:
    """Whether the kernel can read ``t`` [S, n] in place: each row's
    samples adjacent (any row stride, 0 included)."""
    return t.stride(1) == 1 or t.shape[1] <= 1


def fused_resample(data: torch.Tensor, r_t: torch.Tensor, *, ipx: int,
                   wx: int, p2: int, n_frames: int,
                   op: BandedOperator | None = None,
                   tier: str,
                   head: torch.Tensor | int | None = None,
                   width: int | None = None) -> torch.Tensor:
    """y [S, n_frames*p2] with y[s, m*p2 + r] = sum_w v[s, m*ipx + w] *
    r_t[w, r], at the resolved matmul tier ``tier``
    (``precision.check_tier``), over the virtual rows ``v = head ++ data ++
    zeros`` of ``width`` columns (:func:`virtual_row`; by default ``v`` is
    ``data``).  ``head`` is an [S, C] tensor (a streaming step's carry),
    an int C for C zeros (a left context), or None; ``width`` must cover
    the frames, ``(n_frames-1)*ipx + wx``.

    CUDA tensors go to the kernel, which reads the head and the data where
    they lie (float32 rows of adjacent samples, at any row stride, on one
    device) and the zeros from nowhere, and raises on anything else; CPU
    tensors get :func:`fused_resample_reference`.  ``op`` is
    ``banded.prepare(r_t, tier)``, built once with the operator; a CUDA
    call requires it, at the call's tier, and the plain version does not
    read it.
    """
    global launches, inplace_launches
    _check(data, r_t, ipx, wx, p2, n_frames, head, width)
    check_tier(tier)
    with span(K1):
        if data.device.type == "cpu" and r_t.device.type == "cpu":
            return fused_resample_reference(data, r_t, ipx=ipx, wx=wx, p2=p2,
                                            n_frames=n_frames, tier=tier,
                                            head=head, width=width)
        tensors = [data, r_t] + ([head] if isinstance(head, torch.Tensor)
                                 else [])
        if data.device.type != "cuda" or any(t.device != data.device
                                             for t in tensors):
            raise ValueError(f"fused_resample: data on {data.device}, r_t "
                             f"on {r_t.device}; all must be on one CUDA "
                             "device (or all on the CPU)")
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError(f"fused_resample: the CUDA kernel takes float32, "
                            f"got data {data.dtype} and r_t {r_t.dtype}")
        if not (r_t.is_contiguous() and all(_rows(t) for t in tensors)):
            raise ValueError("fused_resample: r_t must be contiguous, and "
                             "the rows of data and head contiguous")
        s = data.shape[0]
        y = torch.empty((s, n_frames * p2), dtype=torch.float32,
                        device=data.device)
        if y.numel() == 0:
            return y
        op = resolve(op, r_t, "fused_resample", tier)
        c = _head_width(head)
        ht = head if isinstance(head, torch.Tensor) and c else None
        fn = _launcher()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(data.data_ptr(), data.stride(0),
                     ht.data_ptr() if ht is not None else None,
                     ht.stride(0) if ht is not None else 0, c,
                     data.shape[1], op.packed.data_ptr(), op.bands.data_ptr(),
                     y.data_ptr(), s * n_frames, n_frames, ipx, wx, p2,
                     op.split, TIER_CODES[tier], stream)
        if err:
            raise RuntimeError(f"fused_resample: kernel launch failed with "
                               f"CUDA error {err} (S={s}, "
                               f"n_frames={n_frames}, ipx={ipx}, wx={wx}, "
                               f"p2={p2}, head={c}, tier={tier})")
        launches += 1
        inplace_launches += int(
            c > 0 or c + data.shape[1] < (n_frames - 1) * ipx + wx)
        return y


@functools.cache
def _launcher():
    """The kernel's C launcher with its ctypes signature (built once)."""
    fn = _build.load(_SOURCE).fused_resample_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn
