"""The work of a request, counted as a direct implementation needs it, and
the card's published peaks: the yardstick of every roofline share.

Operations are 2 x the multiply-adds of each stage's polyphase taps for
every sample that stage emits, from the reference's own filters
(:mod:`portbench.reference.design`), whatever kernel or operator the
program runs:

- the two-stage walk: the 2x prestage emits F samples an input sample,
  each of T1 taps, and the walk T2 taps an output sample;
- decimation: T taps an output sample.

Bytes are each float32 input sample read once and each output sample
written once.  The peaks are NVIDIA's data-sheet figures (dense, without
sparsity) for a card at its full power limit; ``nvidia_smi`` reads the
card's own limit, which every run prints.
"""

from __future__ import annotations

import subprocess

from .reference.design import Decimation, TwoStage

#: Dense peaks by ``torch.cuda.get_device_name()``: bf16 and TF32
#: tensor-core TFLOP/s, float32 TFLOP/s outside the tensor cores, HBM GB/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 495.0, 67.0, 3350.0),   # SXM5
    "NVIDIA H100 PCIe": (756.0, 378.0, 51.0, 2000.0),
}
#: TF32 passes of one float32-accurate product (the 'highest' tier: the
#: hi*hi, hi*lo and lo*hi passes).
FLOAT32_PASSES = 3
BYTES_PER_SAMPLE = 4


def work(filters, n_in: int, n_out: int) -> tuple[int, int]:
    """(operations, bytes) of one stream's request that reads ``n_in``
    samples and writes ``n_out``."""
    if isinstance(filters, TwoStage):
        f, t1 = filters.pre.shape
        macs = f * t1 * n_in + filters.bank.shape[1] * n_out
    elif isinstance(filters, Decimation):
        macs = len(filters.coeffs) * n_out
    else:
        raise TypeError(f"no work count for {type(filters).__name__}")
    return 2 * macs, BYTES_PER_SAMPLE * (n_in + n_out)


def least_seconds(card: str, ops: float, nbytes: float) -> float:
    """The least time the card ``card`` needs for ``ops`` float32-accurate
    tensor-core operations and ``nbytes`` of HBM traffic."""
    _, tf32, _, gbps = PEAKS[card]
    return max(ops / (tf32 / FLOAT32_PASSES * 1e12), nbytes / (gbps * 1e9))


def nvidia_smi(fields: str) -> str:
    """``fields`` of each card as ``nvidia-smi --query-gpu`` prints them
    (``name,power.limit``: the card and its power limit), or 'not read'."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"
