"""Device kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version."""

from .fused import fused_resample, fused_resample_reference
from .general import general_resample, general_resample_reference
from .tmajor import fused_resample_tmajor, fused_resample_tmajor_reference

__all__ = ["fused_resample", "fused_resample_reference",
           "fused_resample_tmajor", "fused_resample_tmajor_reference",
           "general_resample", "general_resample_reference"]
