"""Test-signal synthesis (host-side numpy).

Mirrors the reference test suite's signal generators: pure sine, multitone,
alias-tones (tones placed only between output and input Nyquist), white
noise, DC, and impulse (antialiasing_test.go:616-632,
quality_comparison_test.go:99-113, quality_regression_test.go:296-300).
"""

from __future__ import annotations

import numpy as np


def sine(n: int, freq: float, rate: float, amplitude: float = 0.9) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    return amplitude * np.sin(2.0 * np.pi * freq * t / rate)


def multitone(n: int, freqs, rate: float, amplitude: float = 0.05) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    out = np.zeros(n, dtype=np.float64)
    for f in freqs:
        out += amplitude * np.sin(2.0 * np.pi * f * t / rate)
    return out


def passband_tones(n: int, input_rate: float, output_rate: float,
                   num_freqs: int = 20, amplitude: float = 0.05):
    """20 tones from 500 Hz across 90% of the lower Nyquist.

    Reference parity: measurePassbandRipple (quality_comparison_test.go:90-113).
    """
    passband_end = min(input_rate, output_rate) / 2.0 * 0.9
    freqs = []
    f = 500.0
    while f < passband_end and len(freqs) < num_freqs:
        freqs.append(f)
        f += passband_end / num_freqs
    return multitone(n, freqs, input_rate, amplitude), freqs


def alias_tones(n: int, input_rate: float, output_rate: float,
                amplitude: float = 0.1) -> np.ndarray:
    """Tones only in the would-alias region (outNyq+1k .. inNyq-500, 1k apart).

    Reference parity: generateAliasTones (antialiasing_test.go:616-632).
    """
    out = np.zeros(n, dtype=np.float64)
    t = np.arange(n, dtype=np.float64)
    freq = output_rate / 2.0 + 1000.0
    while freq < input_rate / 2.0 - 500.0:
        out += amplitude * np.sin(2.0 * np.pi * freq * t / input_rate)
        freq += 1000.0
    return out


def white_noise(n: int, amplitude: float = 0.5, seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return amplitude * rng.uniform(-1.0, 1.0, n)


def impulse(n: int, position: int = 0, amplitude: float = 1.0) -> np.ndarray:
    out = np.zeros(n, dtype=np.float64)
    out[position] = amplitude
    return out


def dc(n: int, level: float = 1.0) -> np.ndarray:
    return np.full(n, level, dtype=np.float64)
