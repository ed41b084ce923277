"""Pipeline planning, inter-stage plumbing (host side) and whole-pipeline
fusion."""

from .buffer import SampleFIFO
from .fused import (MAX_FUSED_WIDTH, BandedLengthModel, BandedOp, BandedPlan,
                    banded_from_plan, banded_op_from_arrays, compose,
                    fuse_chain)
from .planner import (
    StageType, StageSpec, QualityParams, Pipeline, PipelineError,
    build_pipeline, optimize_pipeline, should_use_fft,
    calculate_half_band_taps, calculate_polyphase_taps,
    calculate_polyphase_phases, calculate_cutoff_factor,
    calculate_interpolation_order, calculate_fft_size,
    COMMON_AUDIO_RATIOS,
)

__all__ = [
    "StageType", "StageSpec", "QualityParams", "Pipeline", "PipelineError",
    "build_pipeline", "optimize_pipeline", "should_use_fft",
    "calculate_half_band_taps", "calculate_polyphase_taps",
    "calculate_polyphase_phases", "calculate_cutoff_factor",
    "calculate_interpolation_order", "calculate_fft_size",
    "COMMON_AUDIO_RATIOS", "SampleFIFO", "MAX_FUSED_WIDTH", "BandedOp",
    "BandedLengthModel", "BandedPlan", "banded_from_plan",
    "banded_op_from_arrays", "compose", "fuse_chain",
]
