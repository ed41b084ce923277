"""Device-resident serving loop: resample -> ML ingest with no host syncs.

Counterpart of the JAX repo's ``examples/device_serving.py``.  Audio
chunks arrive as tensors on the card, ``process_device`` runs each chunk
as one K1 launch (the 48k -> 16k decimation step) whose output stays on
the card (output counts are static, so nothing waits for the host), and
the consumer, here a toy feature extractor standing in for an ML model,
chains directly on the card's tensors.  The host only enqueues; the
samples never pass through it.

Also shown: snapshotting the live stream mid-flight with
``save_stream_state`` and resuming bit for bit in a fresh engine, the
serving-restart story (``engine/checkpoint.py``), and the pipelined host
stream for consumers that need numpy.

Run:  python -m go_audio_resampler_tpu_torch.examples.device_serving
      [--device cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from go_audio_resampler_tpu_torch.engine import (
    EngineCore, plan_engine, save_stream_state, load_stream_state)
from go_audio_resampler_tpu_torch.filterdesign import Quality


def toy_ingest(frames_16k: torch.Tensor) -> torch.Tensor:
    """Stand-in for a model front end: log-energy over 400-sample hops."""
    n = (frames_16k.shape[1] // 400) * 400
    w = frames_16k[:, :n].reshape(frames_16k.shape[0], -1, 400)
    return torch.log1p((w * w).sum(dim=-1))


def main(device='cuda') -> dict:
    # 64 concurrent 48 kHz streams -> 16 kHz model rate.
    plan = plan_engine(48000.0, 16000.0, Quality.HIGH)
    eng = EngineCore(plan, batch=64, block=4096, dtype=torch.float32,
                     device=device)
    mult = eng.device_chunk_multiple
    chunk = (48000 // mult) * mult          # ~1 s of audio per call
    print(f"chunk multiple {mult}, serving {chunk}-sample chunks")

    rng = np.random.default_rng(0)
    feats = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "serving_ckpt.npz")
        for step in range(5):
            # In production this tensor comes straight from the data
            # pipeline; nothing below synchronizes with the host.
            x = torch.as_tensor(
                rng.standard_normal((64, chunk), np.float32) * 0.3,
                device=device)
            y16 = eng.process_device(x)     # one launch, stays on device
            feats.append(toy_ingest(y16))   # chained device work

            if step == 2:
                # Snapshot the live stream (host-side by nature); a
                # restarted process resumes bit for bit from the file.
                save_stream_state(eng, ckpt)
                print("checkpointed mid-stream at step 2")

        tail = eng.flush_device()
        feats.append(toy_ingest(tail))
        total = sum(int(f.shape[1]) for f in feats)
        print(f"served {total} feature frames x 64 streams (first values "
              f"{feats[0][0, :3].cpu().numpy().round(3)})")

        # Restart drill: a fresh engine resumes from the snapshot and
        # emits exactly what the original would have from step 3 on.
        eng2 = EngineCore(plan, batch=64, block=4096, dtype=torch.float32,
                          device=device)
        load_stream_state(eng2, ckpt)
    print(f"resumed: samples_in={eng2.samples_in}, "
          f"samples_out={eng2.samples_out}")

    # Host-consumer variant: when the output must land in numpy (file
    # writers, non-torch consumers), the pipelined generator overlaps the
    # download of chunk k with chunk k+1's device compute
    # (EngineCore.stream, one-chunk download lag): no threads, just
    # asynchronous launches.
    eng3 = EngineCore(plan, batch=64, block=4096, dtype=torch.float32,
                      device=device)
    chunks = (rng.standard_normal((64, chunk)).astype(np.float32) * 0.3
              for _ in range(3))
    hosted = list(eng3.stream(chunks))
    n_out = sum(y.shape[1] for y in hosted)
    print(f"pipelined host stream: {n_out} samples x 64 streams")
    return {"features": torch.cat(feats, dim=1).cpu().numpy(),
            "samples_in": eng2.samples_in, "samples_out": eng2.samples_out,
            "stream": np.concatenate(hosted, axis=1)}


if __name__ == "__main__":
    from . import run
    run(main, __doc__)
