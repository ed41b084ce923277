"""Device kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version; and the convolution lowerings (``convolve``)."""

from .convolve import conv1d_poly, set_conv_impl
from .fused import fused_resample, fused_resample_reference
from .general import general_resample, general_resample_reference
from .tmajor import fused_resample_tmajor, fused_resample_tmajor_reference

__all__ = ["conv1d_poly", "set_conv_impl",
           "fused_resample", "fused_resample_reference",
           "fused_resample_tmajor", "fused_resample_tmajor_reference",
           "general_resample", "general_resample_reference"]
