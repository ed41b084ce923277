"""Basic usage: one-shot, streaming and variable-rate conversion.

Counterpart of the JAX repo's ``examples/basic.py``.  On the card the
one-shot and the streaming chain each run K1, the fused banded kernel;
the variable-rate glissando runs none (its 'vr' step is elementwise).

Run:  python -m go_audio_resampler_tpu_torch.examples.basic [--device cpu]
"""

from __future__ import annotations

import numpy as np

import go_audio_resampler_tpu_torch as gar


def main(device='cuda') -> dict:
    # 1 second of a 1 kHz sine at CD rate
    rate_in, rate_out = gar.RATE_CD, gar.RATE_DAT
    t = np.arange(rate_in) / rate_in
    x = 0.8 * np.sin(2 * np.pi * 1000.0 * t)

    # One-shot conversion (simplest API)
    y = gar.resample_mono(x, rate_in, rate_out, gar.QualityPreset.HIGH,
                          device=device)
    print(f"one-shot: {len(x)} samples @ {rate_in} Hz -> "
          f"{len(y)} samples @ {rate_out} Hz")

    # Streaming conversion with explicit configuration
    r = gar.new_resampler(gar.Config(
        input_rate=rate_in, output_rate=rate_out, channels=1,
        quality=gar.QualitySpec(preset=gar.QualityPreset.HIGH),
        device=device))
    chunks = [x[i:i + 4096] for i in range(0, len(x), 4096)]
    outs = [r.process(c) for c in chunks]
    outs.append(r.flush())
    streamed = np.concatenate(outs)
    # The pipeline maps the High preset to its 24-bit stage filter while
    # resample_mono uses the direct engine's High filter, so the two
    # streams differ within each filter's transient and ripple: compare
    # against the matching oracle.
    plan = gar.plan_engine(float(rate_in), float(rate_out),
                           gar.precision_to_engine_quality(24))
    oracle = gar.oneshot(plan, x[None, :], dtype=streamed.dtype,
                         device=device)[0].cpu().numpy()
    n = min(len(streamed), len(oracle))
    print(f"streaming: {len(streamed)} samples; matches its one-shot "
          f"oracle: {bool(np.allclose(streamed[:n], oracle[:n]))}")

    info = gar.get_info(r)
    print(f"algorithm: {info.algorithm}, taps: {info.filter_length}, "
          f"latency: {info.latency} samples, backend: {info.simd_type}")
    return {"oneshot": y, "streamed": streamed, "oracle": oracle,
            **variable_rate_glissando(device)}


def variable_rate_glissando(device='cuda') -> dict:
    """Variable-rate mode (beyond the Go reference): a ratio glide."""
    vr = gar.new_variable_rate(48000, 96000, output_rate=48000,
                               dtype=np.float32, device=device)
    tone = np.sin(2 * np.pi * 440.0 / 48000.0
                  * np.arange(48000, dtype=np.float32))
    head = vr.process(tone[:24000])          # steady at 1:1
    vr.set_io_ratio(0.5, slew_len=12000)     # glide to 2x output rate
    tail = vr.process(tone[24000:])
    rest = vr.flush()
    total = head.shape[1] + tail.shape[1] + rest.shape[1]
    print(f"variable-rate: {len(tone)} in -> {total} out "
          f"(final io_ratio {vr.get_io_ratio():.3f})")
    return {"glissando": np.concatenate([head, tail, rest], axis=1)}


if __name__ == "__main__":
    from . import run
    run(main, __doc__)
