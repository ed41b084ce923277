"""Multi-card stream-parallel resampling (beyond the Go reference).

Counterpart of the JAX repo's ``examples/sharded.py``.  Channels and
streams are independent, so the port scales across cards with pure data
parallelism: each rank of a ``torch.distributed`` group (one process a
card) runs the same per-block program on its rows of the stream batch,
and no sample crosses ranks.  The reference's analog is
goroutine-per-channel fan-out (constant.go:224-241).

The mesh is the caller's process group (e.g. ``torchrun``'s, one rank a
card); where there is none, a one-rank group is set up for the run (and
taken down after it): ``nccl`` on the card, ``gloo`` on the CPU.  On the
card the one-shot and the streaming step run K1.

Run:  python -m go_audio_resampler_tpu_torch.examples.sharded
      [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from go_audio_resampler_tpu_torch.engine import plan_engine
from go_audio_resampler_tpu_torch.filterdesign import Quality
from go_audio_resampler_tpu_torch.parallel import (
    ShardedEngineCore, make_mesh, sharded_oneshot)


def main(device='cuda') -> dict:
    device_type = torch.device(device).type
    own_group = not dist.is_initialized()
    mesh = make_mesh(device_type=device_type)
    try:
        return _run(mesh, device_type)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(mesh, device_type: str) -> dict:
    ranks = mesh.size()
    print(f"mesh: {ranks} x {device_type}")

    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    rng = np.random.default_rng(0)

    # One-shot: a batch of streams resampled by every rank on its rows.
    n_streams = 4 * ranks
    x = rng.normal(size=(n_streams, 44100)).astype(np.float32) * 0.5
    y = sharded_oneshot(plan, x, mesh).full_tensor().cpu().numpy()
    print(f"one-shot: {x.shape} -> {y.shape} "
          f"({n_streams} streams, {ranks} devices)")

    # Streaming: a stateful engine on each rank's rows.
    eng = ShardedEngineCore(plan, mesh, batch_per_device=2, block=2048)
    batch = eng.batch * ranks                # the global batch
    outs = [eng.process(x[:batch, i:i + 4096])
            for i in range(0, 44100, 4096)]
    outs.append(eng.flush())
    ys = np.concatenate(outs, axis=1)
    print(f"streaming: {batch} streams -> {ys.shape[1]} samples each")
    # Sharded streaming equals the one-shot canonical stream.
    m = min(ys.shape[1], y.shape[1])
    d = float(np.abs(ys[:, :m] - y[:batch, :m]).max())
    print(f"sharded streaming vs one-shot maxdiff: {d:.2e}")
    assert d < 1e-4
    return {"oneshot": y, "streamed": ys}


if __name__ == "__main__":
    from . import run
    run(main, __doc__)
