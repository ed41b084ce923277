"""Device kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version."""

from .fused import fused_resample, fused_resample_reference

__all__ = ["fused_resample", "fused_resample_reference"]
