"""Roofline accounting of the banded products on a Hopper card.

PyTorch counterpart of the JAX package's ``utils/roofline.py``.  Every
timed device program of the engine is a banded periodic product whose
operation count per input sample is fixed by the plan: the [P2, Wx]
matrix, the input stride Ipx a period.  This module turns a measured
Msamples/s into

  - ``tflops_achieved``  -- useful Tflop/s implied by the matrix dims,
  - ``mfu_pct``          -- achieved share of the tier's effective
                            tensor-core peak,
  - ``mfu_slot_pct``     -- achieved share of the tile-padded ceiling: the
                            kernels (K1, K2: ``ops/csrc/banded_mma.cuh``)
                            run ``wgmma`` tiles of n = 80 columns of P2
                            and k = 8 taps a step at ``'highest'`` (TF32),
                            16 at the bf16 tiers, so a [*, 343] x [343, 160]
                            product runs roundup(160, 80) x roundup(343,
                            8) multiply-adds per frame row whether or not
                            the operands fill them,
  - ``hbm_gbps`` / ``hbm_pct`` -- the bandwidth the read model implies,
  - ``bound``            -- the named binding resource.

Tiers.  ``TIER_PASSES`` counts each tier in bf16-pass equivalents against
the card's dense bf16 peak: ``'default'`` is one bf16 pass, ``'high'``
three, and ``'highest'`` three TF32 passes, each at half the bf16 rate on
Hopper's tensor cores, so six.  On an H100 SXM that gives 989 / 6 = 165
TFLOP/s, which is 495 / 3: the 3xTF32 bound the port's kernel tables use.

Peaks come from NVIDIA's data sheets (dense rates, without sparsity),
keyed by ``torch.cuda.get_device_name``; an unknown card raises and names
it, and a caller on another card passes ``peaks=`` to :func:`analyze`.
"""

from __future__ import annotations

import subprocess

__all__ = [
    "device_peaks", "peaks_of", "power_limit", "banded_model",
    "general_model", "analyze", "TIER_PASSES", "P2_GRANULE", "K_GRANULE",
]

#: Dense peaks by card name: bf16 and TF32 tensor-core Tflop/s, float32
#: Tflop/s outside the tensor cores, HBM GB/s (NVIDIA data sheets).
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 495.0, 67.0, 3350.0),   # SXM5
    "NVIDIA H100 PCIe": (756.0, 378.0, 51.0, 2000.0),
}

#: bf16-pass equivalents of one float32 product at each tier.
TIER_PASSES = {"highest": 6, "high": 3, "default": 1}

#: The kernels' tiles: ``wgmma`` n = 80 columns of P2; k = 8 taps a step
#: at 'highest' (TF32 k8), 16 at the bf16 tiers (k16).
P2_GRANULE = 80
K_GRANULE = {"highest": 8, "high": 16, "default": 16}


def peaks_of(name: str, power_limit: str | None = None) -> dict:
    """The published peaks of the card called ``name``; raises
    ``KeyError`` naming it when the table does not know it."""
    if name not in _PEAKS:
        raise KeyError(f"no published peaks for the card {name!r} (known: "
                       f"{sorted(_PEAKS)}); pass peaks= to analyze()")
    bf16, tf32, fp32, gbps = _PEAKS[name]
    return {"kind": name, "bf16_tflops": bf16, "tf32_tflops": tf32,
            "fp32_tflops": fp32, "hbm_gbps": gbps,
            "power_limit": power_limit}


def power_limit(index: int = 0) -> str | None:
    """Card ``index``'s power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints it, or None where
    ``nvidia-smi`` is not there."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    if index >= len(out):
        return None
    return out[index].rsplit(",", 1)[-1].strip()


def device_peaks(device=None) -> dict:
    """Peaks of the local card (``device``: an index or ``torch.device``,
    the current card by default) from its name, with its power limit.

    Returns ``{"kind", "bf16_tflops", "tf32_tflops", "fp32_tflops",
    "hbm_gbps", "power_limit"}``.  Raises without a card and for a card
    the table does not know."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("device_peaks: CUDA is not available, so there "
                           "is no card to read; pass peaks= to analyze()")
    if device is None:
        index = torch.cuda.current_device()
    elif isinstance(device, int):
        index = device
    else:
        index = torch.device(device).index or 0
    return peaks_of(torch.cuda.get_device_name(index), power_limit(index))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def banded_model(p2: int, wx: int, ipx: float, *, read_amp: float = 1.08,
                 nnz: int | None = None, bytes_elem: int = 4,
                 p2_granule: int = P2_GRANULE,
                 k_granule: int = K_GRANULE["highest"]) -> dict:
    """Static op counts per input sample of a [P2 x Wx] banded step.

    One period consumes ``ipx`` input samples and emits ``p2`` outputs
    through a dense [Wx, P2] product (flops := 2 * MACs); ``nnz``, where
    given, also reports the work on the matrix's non-zeros.

    ``read_amp`` -- reads of x per input sample from memory (the kernel
    re-reads only the overlap of its frames).

    Slot model: the kernel runs tiles of ``p2_granule`` output columns
    by ``k_granule`` taps, so per frame row it runs
    ``roundup(P2, p2_granule) * roundup(Wx, k_granule)`` multiply-adds.
    The JAX package's TPU tiles are ``p2_granule=128, k_granule=128``.
    """
    flops = 2.0 * p2 * wx / ipx
    slots = (2.0 * _round_up(p2, p2_granule) * _round_up(wx, k_granule)
             / ipx)
    return {
        # ipx may be fractional for quasi-periodic walks.
        "p2": int(p2), "wx": int(wx), "ipx": float(ipx),
        "flops_per_in": flops,
        "slots_per_in": slots,
        "useful_frac_of_slots": flops / slots,
        "nnz_flops_per_in": (2.0 * nnz / ipx) if nnz is not None else None,
        "bytes_per_in": bytes_elem * (read_amp + p2 / ipx),
    }


def general_model(*, factor: int, pre_taps: int, poly_taps: int,
                  num_phases: int, step_hi: int, block: int, poly_cap: int,
                  tile: int = 256,
                  k_granule: int = K_GRANULE["highest"]) -> dict:
    """Static op model of the general (non-exact-rational) streaming step.

    The prestage convolution (factor x pre_taps per input; K1, its taps
    padded to ``k_granule``) followed by the banded-tile polyphase emit
    (``stages._poly_emit_banded``): per tile of ``tile`` outputs one
    [S, span] x [span, tile] product, ``span`` the static window-span
    bound of ``stages.poly_process`` (128-aligned), plus the Horner
    coefficient interpolation (~6 * poly_taps flops an output).  The walk
    computes the padded cap every block, so computed outputs per input =
    roundup(poly_cap, tile) / block.  The bytes model is per stream and
    coarse (x once, u written and read, the output written).  The JAX
    package's TPU granule is ``k_granule=128``.
    """
    div_adv = ((tile - 1) * (step_hi + 1)) // num_phases + 1
    span = _round_up(div_adv + poly_taps, 128)
    cap_pad = _round_up(poly_cap, tile)
    outs_per_in = cap_pad / block
    pre_flops = 2.0 * factor * pre_taps
    emit_flops = 2.0 * span * outs_per_in
    horner_flops = 6.0 * poly_taps * outs_per_in
    flops = pre_flops + emit_flops + horner_flops
    slots = (2.0 * factor * _round_up(pre_taps, k_granule)
             + 2.0 * span * outs_per_in + horner_flops)
    return {
        "p2": int(tile), "wx": int(span), "ipx": float(tile / outs_per_in),
        "flops_per_in": flops,
        "slots_per_in": slots,
        "useful_frac_of_slots": flops / slots,
        "nnz_flops_per_in": None,
        "bytes_per_in": 4.0 * (1.0 + 2.0 * factor + outs_per_in),
    }


def analyze(msps: float, model: dict, tier: str = "highest",
            peaks: dict | None = None) -> dict:
    """Roofline verdict for a measured throughput.

    ``msps`` -- measured Msamples/s (input samples); ``model`` -- from
    :func:`banded_model` or :func:`general_model`; ``tier`` -- the matmul
    tier of the timed program; ``peaks`` -- by default
    :func:`device_peaks` of the current card.

    ``bound`` names the binding resource:

    - ``hbm``          -- the implied bandwidth exceeds ~60% of the card's
                          HBM peak (and more of it than of the tensor
                          cores): faster math would not help.
    - ``tensor_cores`` -- the padded slots exceed ~60% of the tier's effective
                          peak; ``tensor_cores(tile-padding)`` where the
                          useful share of those slots is low (the fix is
                          the plan's geometry, not the kernel).
    - ``framing``      -- neither is near its roof: per-step overheads
                          (loads, launch, host enqueue) dominate.
    """
    peaks = peaks or device_peaks()
    passes = TIER_PASSES[tier]
    eff_peak_tflops = peaks["bf16_tflops"] / passes
    tflops = msps * 1e6 * model["flops_per_in"] / 1e12
    tslots = msps * 1e6 * model["slots_per_in"] / 1e12
    mfu = 100.0 * tflops / eff_peak_tflops
    mfu_slot = 100.0 * tslots / eff_peak_tflops
    gbps = msps * 1e6 * model["bytes_per_in"] / 1e9
    hbm_pct = 100.0 * gbps / peaks["hbm_gbps"]
    if hbm_pct >= 60.0 and hbm_pct >= mfu_slot:
        bound = "hbm"
    elif mfu_slot >= 60.0:
        bound = "tensor_cores"
        if model["useful_frac_of_slots"] < 0.75:
            bound = "tensor_cores(tile-padding)"
    else:
        bound = "framing"
    return {
        "tier": tier,
        "tflops_achieved": round(tflops, 2),
        "mfu_pct": round(mfu, 1),
        "mfu_slot_pct": round(mfu_slot, 1),
        "hbm_gbps": round(gbps, 1),
        "hbm_pct": round(hbm_pct, 1),
        "eff_peak_tflops": round(eff_peak_tflops, 1),
        "bound": bound,
        "chip": peaks["kind"],
    }
