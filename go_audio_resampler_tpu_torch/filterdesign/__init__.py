"""Host-side filter design for the PyTorch resampler.

Everything here is pure numpy float64 and runs once at resampler
construction; the engine copies the results to the device as tensors.
A copy of the JAX package's module, kept bit-equal to it.
"""

from .bessel import (
    bessel_i0,
    bessel_i1,
    bessel_i0_ratio,
    kaiser_beta,
    kaiser_beta_with_tr_bw,
    kaiser_attenuation,
    estimate_filter_length,
    MIN_FILTER_LENGTH,
    MAX_FILTER_LENGTH,
)
from .kaiser import (
    FilterParams,
    FilterResponse,
    FilterDesignError,
    kaiser_window,
    design_lowpass,
    design_lowpass_auto,
    frequency_response,
    magnitude_db,
)
from .params import (
    Quality,
    DB_PER_BIT,
    PHASE_FRAC_BITS,
    PHASE_FRAC_SCALE,
    PHASE_FRAC_MASK,
    PolyphaseFilterParams,
    PolyphaseFilter,
    DFTUpsampleFilter,
    DecimationFilter,
    quality_to_attenuation,
    quality_to_passband_end,
    lsx_inv_f_resp,
    compute_polyphase_filter_params,
    find_rational_approx,
    design_polyphase_filter,
    polyphase_step,
    cubic_phase_banks,
    design_dft_upsample,
    design_decimation,
)
from .polyphase_bank import (
    InterpolationOrder,
    PolyphaseFilterBank,
    design_polyphase_bank,
)

__all__ = [
    "bessel_i0", "bessel_i1", "bessel_i0_ratio", "kaiser_beta",
    "kaiser_beta_with_tr_bw", "kaiser_attenuation", "estimate_filter_length",
    "MIN_FILTER_LENGTH", "MAX_FILTER_LENGTH",
    "FilterParams", "FilterResponse", "FilterDesignError", "kaiser_window",
    "design_lowpass", "design_lowpass_auto", "frequency_response",
    "magnitude_db",
    "Quality", "DB_PER_BIT", "PHASE_FRAC_BITS", "PHASE_FRAC_SCALE",
    "PHASE_FRAC_MASK", "PolyphaseFilterParams", "PolyphaseFilter",
    "DFTUpsampleFilter", "DecimationFilter", "quality_to_attenuation",
    "quality_to_passband_end", "lsx_inv_f_resp",
    "compute_polyphase_filter_params", "find_rational_approx",
    "design_polyphase_filter", "polyphase_step", "cubic_phase_banks",
    "design_dft_upsample", "design_decimation",
    "InterpolationOrder", "PolyphaseFilterBank", "design_polyphase_bank",
]
