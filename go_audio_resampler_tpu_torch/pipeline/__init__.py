"""Inter-stage plumbing (host side) and whole-pipeline fusion."""

from .buffer import SampleFIFO
from .fused import (MAX_FUSED_WIDTH, BandedLengthModel, BandedOp, BandedPlan,
                    banded_from_plan, banded_op_from_arrays, compose,
                    fuse_chain)

__all__ = ["SampleFIFO", "MAX_FUSED_WIDTH", "BandedOp", "BandedLengthModel",
           "BandedPlan", "banded_from_plan", "banded_op_from_arrays",
           "compose", "fuse_chain"]
