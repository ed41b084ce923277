"""Variable-rate resampling (beyond the Go reference).

Counterpart of the JAX repo's ``examples/variable_rate.py``.  The
variable-rate engine implements libsoxr's SOXR_VR mode: the I/O ratio
can be changed at runtime, with an optional linear slew so the pitch
glides instead of jumping (soxr_set_io_ratio semantics).  Its 'vr' step
is elementwise work on the card; it launches none of the port's kernels.

Run:  python -m go_audio_resampler_tpu_torch.examples.variable_rate
      [--device cpu]
"""

from __future__ import annotations

import numpy as np

import go_audio_resampler_tpu_torch as gar


def main(device='cuda') -> dict:
    rate = 48000
    # Up to 2x output rate; start at 1:1 passthrough ratio.
    vr = gar.new_variable_rate(rate, 2 * rate, output_rate=rate,
                               device=device)

    t = np.arange(4 * rate) / rate
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)

    blocks = []
    chunk = 4800
    for i in range(0, len(x), chunk):
        if i == len(x) // 2:
            # Mid-stream: glide to 1.5x output rate over ~100 ms of input.
            vr.set_io_ratio(rate / (1.5 * rate), slew_len=4800)
        blocks.append(vr.process(x[i:i + chunk]))
    blocks.append(vr.flush())
    y = np.concatenate([np.atleast_2d(b)[0] for b in blocks])

    # First half ran at 1:1, second half glided to 1.5x: expect roughly
    # 2s + 3s = 5s of output.
    expect = 2.0 * rate + 3.0 * rate
    print(f"in:  {len(x)} samples ({len(x)/rate:.1f} s at {rate} Hz)")
    print(f"out: {len(y)} samples (~{len(y)/rate:.2f} s at {rate} Hz; "
          f"expected ~{expect/rate:.1f} s with the mid-stream slew)")
    assert abs(len(y) - expect) < 0.1 * expect
    return {"y": y}


if __name__ == "__main__":
    from . import run
    run(main, __doc__)
