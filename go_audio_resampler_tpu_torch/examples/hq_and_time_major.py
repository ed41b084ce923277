"""HQ non-exact ratios and time-major serving.

Counterpart of the JAX repo's ``examples/hq_and_time_major.py``.  Two
things the reference library cannot do:

1. ``hq_interp=True``: the upstream's general (non-exact-ratio) walk
   interpolates its phase banks with a boundary-wrap defect that floors
   THD near -88 dB (polyphase_stage.go:105-117; reproduced bit for bit
   by default, for parity).  The opt-in mode corrects the wrap and
   designs 8x denser banks at the same per-output cost.  On the card the
   walk's 2x prestage runs K1.  On an NVIDIA H100 80GB HBM3 (700 W power
   limit) ``chip_smoke.py`` phase 16 read THD -82.20 dB by default and
   -160.54 dB with ``hq_interp``.

2. ``engine.TimeMajorEngine``: device-resident serving for data stored
   time-major ([samples, streams]), which interleaved multi-channel
   audio already is; its step is K2, the time-major banded kernel.

Run:  python -m go_audio_resampler_tpu_torch.examples.hq_and_time_major
      [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import go_audio_resampler_tpu_torch as gar
from go_audio_resampler_tpu_torch.engine import TimeMajorEngine, plan_engine
from go_audio_resampler_tpu_torch.filterdesign import Quality
from go_audio_resampler_tpu_torch.utils.metrics import thd


def hq_interp_demo(device='cuda') -> dict:
    """44.1k -> 48,001 Hz (no small rational form): default vs HQ."""
    rate_in, rate_out = 44100, 48001
    t = np.arange(rate_in) / rate_in
    x = 0.9 * np.sin(2 * np.pi * 997.0 * t)

    out = {}
    for hq in (False, True):
        eng = gar.new_engine_float32(rate_in, rate_out,
                                     gar.QualityPreset.HIGH, hq_interp=hq,
                                     device=device)
        y = np.concatenate([eng.process(x), eng.flush()])
        val = thd(y, rate_out, 997.0)
        mode = "hq_interp" if hq else "default (reference parity)"
        print(f"  {mode:28s} THD = {val:8.2f} dB   ({len(y)} samples)")
        key = "hq" if hq else "default"
        out[key], out[f"thd_{key}_db"] = y, val
    return out


def time_major_demo(device='cuda') -> dict:
    """CD->DAT serving on interleaved ([samples, channels]) data."""
    channels = 8
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    eng = TimeMajorEngine(plan, batch=channels, block=2048, device=device)

    # Interleaved audio is already [samples, channels]: no transpose.
    n = 4 * eng.chunk_multiple * (2048 // eng.chunk_multiple)
    rng = np.random.default_rng(7)
    xt = torch.as_tensor(rng.standard_normal((n, channels)).astype(
        np.float32), device=device)

    chunks = [eng.process_device(c)
              for c in xt.chunk(4, dim=0)]           # stays on device
    chunks.append(eng.flush_device())
    yt = torch.cat([c for c in chunks if c.shape[0]], dim=0)
    print(f"  in  [{n}, {channels}] time-major rows")
    print(f"  out [{yt.shape[0]}, {yt.shape[1]}] rows on "
          f"{yt.device.type} (zero host syncs)")
    return {"time_major": yt.cpu().numpy()}


def main(device='cuda') -> dict:
    print("HQ inter-phase mode (non-exact ratio 44.1k -> 48,001):")
    out = hq_interp_demo(device)
    print("Time-major device-resident serving (44.1k -> 48k, 8 ch):")
    return {**out, **time_major_demo(device)}


if __name__ == "__main__":
    from . import run
    run(main, __doc__)
