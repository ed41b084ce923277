"""Resample-as-a-layer: gradients through the resampler in a training step.

Counterpart of the JAX repo's ``examples/ml_ingest_training.py``.  The
reference is a host-side library: it cannot sit inside a training
program.  Here ``gar.resample`` (``functional.py``) is a differentiable
torch op, so a 48 kHz -> 16 kHz ingest stage can live inside the
training step and backpropagate into a learned front end that runs at
the raw rate.  On the card its forward is one K1 launch; its backward
is the exact transposed operator (the plain version under autograd).

The toy model: a learnable 48 kHz pre-emphasis FIR -> resample to 16 kHz
(QualityHigh) -> linear feature head.  Both parameter groups train
through the resampler.

Run:  python -m go_audio_resampler_tpu_torch.examples.ml_ingest_training
      [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import go_audio_resampler_tpu_torch as gar

RATE_IN, RATE_OUT = 48000.0, 16000.0
N_IN = 4800                       # 100 ms of 48 kHz audio per clip
BATCH = 8
FIR_TAPS = 31
N_OUT = gar.functional.output_length(N_IN, RATE_IN, RATE_OUT,
                                     gar.QualityPreset.HIGH)
FEATS = 16
LR = 0.05


def convolve_same(x: torch.Tensor, fir: torch.Tensor) -> torch.Tensor:
    """``numpy.convolve(row, fir, mode='same')`` of each row of x [B, n]
    for an odd tap count: ``conv1d`` correlates, so the taps are
    flipped."""
    return F.conv1d(x[:, None, :], fir.flip(0)[None, None, :],
                    padding=fir.shape[0] // 2)[:, 0]


class IngestModel(nn.Module):
    """x48 [B, N_IN] -> features [B, FEATS]."""

    def __init__(self, head: np.ndarray, device='cuda'):
        super().__init__()
        fir = torch.zeros(FIR_TAPS, dtype=torch.float32)
        fir[FIR_TAPS // 2] = 1.0
        self.fir = nn.Parameter(fir.to(device))
        # A copy: the optimizer's in-place steps must not reach the
        # caller's array.
        self.head = nn.Parameter(torch.tensor(head, device=device))
        self.device = torch.device(device)

    def forward(self, x48: torch.Tensor) -> torch.Tensor:
        # Learned pre-emphasis at the raw rate (what the gradient must
        # reach through the resampler).
        xf = convolve_same(x48, self.fir)
        # Differentiable 3:1 decimation with the production HIGH filter.
        x16 = gar.resample(xf, RATE_IN, RATE_OUT,
                           quality=gar.QualityPreset.HIGH,
                           device=self.device)
        # Linear feature head at 16 kHz.
        return x16 @ self.head


def loss_fn(model: IngestModel, x48, target) -> torch.Tensor:
    return torch.mean((model(x48) - target) ** 2)


def main(device='cuda') -> dict:
    rng = np.random.default_rng(0)
    # Synthetic task: the "true" front end is a band-emphasis FIR the
    # model must recover through the resampler.
    t = np.arange(FIR_TAPS) - FIR_TAPS // 2
    true_fir = (np.sinc(t / 3.0) * np.hanning(FIR_TAPS)).astype(np.float32)
    true_head = rng.normal(size=(N_OUT, FEATS)).astype(np.float32) * 0.02
    head = torch.as_tensor(true_head, device=device)

    def make_batch():
        x = rng.normal(size=(BATCH, N_IN)).astype(np.float32)
        xf = np.stack([np.convolve(r, true_fir, mode="same") for r in x])
        with torch.no_grad():
            y16 = gar.resample(torch.as_tensor(xf), RATE_IN, RATE_OUT,
                               quality=gar.QualityPreset.HIGH,
                               device=device)
            return torch.as_tensor(x, device=device), y16 @ head

    model = IngestModel(true_head, device)   # head known; learn the FIR
    opt = torch.optim.SGD(model.parameters(), lr=LR)

    x0, y0 = make_batch()
    with torch.no_grad():
        l0 = float(loss_fn(model, x0, y0))
    for step in range(40):
        x, y = make_batch()
        opt.zero_grad()
        loss = loss_fn(model, x, y)
        loss.backward()
        opt.step()
    l1 = loss.item()
    print(f"loss: {l0:.6f} -> {l1:.6f} over 40 steps "
          f"(gradients flowed through the HIGH-quality resampler)")
    assert l1 < 0.2 * l0, (l0, l1)

    # The learned FIR should approach the true band emphasis.
    fir = model.fir.detach().cpu().numpy()
    err = float(np.linalg.norm(fir - true_fir) / np.linalg.norm(true_fir))
    print(f"recovered 48 kHz FIR, relative error {err:.3f}")
    return {"loss_0": l0, "loss_40": l1, "fir": fir, "fir_error": err,
            "head": model.head.detach().cpu().numpy()}


if __name__ == "__main__":
    from . import run
    run(main, __doc__)
