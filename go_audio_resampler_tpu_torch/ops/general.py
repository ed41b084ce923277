"""Per-tile banded resampling at data-dependent starts (K3): the CUDA
kernel and its plain version.

Counterpart of the JAX package's ``ops/pallas_fused.py`` for its kernel
``general_resample_pallas``, the core of the general (non-exact-rational)
and cubic one-shot paths:

    y[s, t*tile + p] = sum_{w < w_band} x[s, starts[t] + w] * m_t[t, w, p]

The matrices are laid out [n_tiles, w, tile], so the kernel reads each
tile's rows contiguously; they need no padding.  ``general_resample``
launches the hand-written kernel in ``csrc/general_resample.cu`` (built at
first use, see ``_build``) for CUDA tensors, and computes the plain
version for CPU tensors.  There is no fallback: a CUDA tensor the kernel
does not take raises.

The TPU module's ``choose_general_tile`` and ``general_vmem_bytes`` only
size TPU tiles to its scoped VMEM and have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .frames import gather_windows_at

#: Kernel launches so far (a plain integer; callers may reset it to 0).
launches = 0

_SOURCE = "general_resample"


def general_resample_reference(x: torch.Tensor, m_t: torch.Tensor,
                               starts: torch.Tensor, *, w_band: int,
                               tile: int) -> torch.Tensor:
    """Plain version: the clipped gather of each tile's window, then one
    ``einsum`` (the JAX package's lowering of ``_banded_tiles_apply``).

    A window sample outside ``x`` reads its nearest end, as the kernel
    clamps it.  Computes in ``x``'s dtype; on a CUDA tensor a float32
    ``einsum`` follows ``torch.backends.cuda.matmul.allow_tf32``, which
    callers that use this as the oracle on the card set to False.
    """
    s, n = x.shape
    n_tiles = m_t.shape[0]
    if n_tiles == 0 or n == 0:
        return x.new_zeros((s, n_tiles * tile))
    frames = gather_windows_at(x, starts, w_band)        # [S, n_tiles, W]
    y = torch.einsum('stw,twp->stp', frames,
                     m_t[:, :w_band, :].to(x.dtype))
    return y.reshape(s, n_tiles * tile)


def _check(x, m_t, starts, w_band, tile):
    if x.dim() != 2 or m_t.dim() != 3 or starts.dim() != 1:
        raise ValueError(
            "general_resample: x [S, n], m_t [n_tiles, w, tile] and starts "
            f"[n_tiles] expected, got {tuple(x.shape)}, {tuple(m_t.shape)} "
            f"and {tuple(starts.shape)}")
    n_tiles, rows, cols = m_t.shape
    if cols != tile or rows < w_band or w_band <= 0:
        raise ValueError(f"general_resample: m_t is {tuple(m_t.shape)}, "
                         f"expected (n_tiles, >= w_band={w_band}, "
                         f"tile={tile})")
    if starts.shape[0] != n_tiles:
        raise ValueError(f"general_resample: {starts.shape[0]} starts for "
                         f"{n_tiles} tiles")
    if starts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"general_resample: starts must be int32 or int64, "
                        f"got {starts.dtype}")


def general_resample(x: torch.Tensor, m_t: torch.Tensor,
                     starts: torch.Tensor, *, w_band: int,
                     tile: int) -> torch.Tensor:
    """y [S, n_tiles*tile] with y[s, t*tile + p] =
    sum_{w < w_band} x[s, starts[t] + w] * m_t[t, w, p].

    CUDA tensors go to the kernel, which takes contiguous float32 ``x`` and
    ``m_t`` and contiguous int32 or int64 ``starts``, all on one device,
    and raises on anything else; CPU tensors get
    :func:`general_resample_reference`.
    """
    global launches
    _check(x, m_t, starts, w_band, tile)
    devices = {x.device, m_t.device, starts.device}
    if devices == {torch.device("cpu")}:
        return general_resample_reference(x, m_t, starts, w_band=w_band,
                                          tile=tile)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"general_resample: x on {x.device}, m_t on "
                         f"{m_t.device}, starts on {starts.device}; all must "
                         "be on one CUDA device (or all on the CPU)")
    if x.dtype != torch.float32 or m_t.dtype != torch.float32:
        raise TypeError(f"general_resample: the CUDA kernel takes float32, "
                        f"got x {x.dtype} and m_t {m_t.dtype}")
    if not (x.is_contiguous() and m_t.is_contiguous()
            and starts.is_contiguous()):
        raise ValueError(
            "general_resample: x, m_t and starts must be contiguous")
    s, n = x.shape
    n_tiles = m_t.shape[0]
    y = torch.empty((s, n_tiles * tile), dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    if n == 0:
        return y.zero_()
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), x.stride(0), n, starts.data_ptr(),
                 int(starts.dtype == torch.int64), m_t.data_ptr(),
                 m_t.shape[1], y.data_ptr(), n_tiles, s, w_band, tile,
                 stream)
    if err:
        raise RuntimeError(
            f"general_resample: kernel launch failed with CUDA error {err} "
            f"(S={s}, n={n}, n_tiles={n_tiles}, w_band={w_band}, "
            f"tile={tile})")
    launches += 1
    return y


@functools.cache
def _launcher():
    """The kernel's C launcher with its ctypes signature (built once)."""
    fn = _build.load(_SOURCE).general_resample_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn
