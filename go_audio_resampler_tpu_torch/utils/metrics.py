"""DSP quality metrics: THD, SNR, passband ripple, anti-aliasing, DC gain.

Host-side numpy port of the reference test suite's measurement
methodology, so quality numbers are directly comparable:

- ``thd``              <-> measureTHDInternal  (quality_regression_test.go:292-345)
- ``snr``              <-> measureSNRInternal  (quality_regression_test.go:347-423)
- ``passband_ripple``  <-> measurePassbandRipple (quality_comparison_test.go:90-186)
- ``antialias_attenuation`` <-> measureDownsamplingAntiAliasing
                                (antialiasing_test.go:636-700)
- ``dc_gain``          <-> measureDCGain (precision_comparison_test.go:443-466)

All functions take the *already resampled* output array (plus rates), so
they are engine-agnostic; resampling itself runs through whichever API the
caller chooses.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_EPS = 1e-20


def _hann(n: int) -> np.ndarray:
    # Reference uses 0.5*(1-cos(2*pi*i/(N-1))) (quality_regression_test.go:314)
    i = np.arange(n, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / (n - 1)))


def _windowed_fft(output: np.ndarray, fft_size: int) -> np.ndarray:
    buf = np.zeros(fft_size, dtype=np.float64)
    m = min(len(output), fft_size)
    buf[:m] = output[:m]
    return np.fft.fft(buf * _hann(fft_size))


def thd(output: np.ndarray, output_rate: float, test_freq: float,
        fft_size: int = 16384) -> float:
    """Total harmonic distortion in dB (2nd..10th harmonic vs fundamental).

    Reference parity: measureTHDInternal (quality_regression_test.go:292-345).
    """
    spec = _windowed_fft(output, fft_size)
    fundamental_bin = int(test_freq / output_rate * fft_size)
    fundamental = abs(spec[fundamental_bin])
    nyquist = output_rate / 2.0
    harmonic_power = 0.0
    for h in range(2, 11):
        hf = test_freq * h
        if hf >= nyquist:
            break
        hb = int(hf / output_rate * fft_size)
        if hb < fft_size // 2:
            harmonic_power += abs(spec[hb]) ** 2
    ratio = np.sqrt(harmonic_power) / (fundamental + _EPS)
    return float(20.0 * np.log10(ratio + _EPS))


def snr(output: np.ndarray, output_rate: float, test_freq: float,
        fft_size: int = 16384) -> float:
    """Signal-to-noise ratio in dB: fundamental +-3 bins vs everything else
    excluding harmonic regions (+-2 bins).

    Reference parity: measureSNRInternal (quality_regression_test.go:347-423).
    """
    spec = _windowed_fft(output, fft_size)
    half = fft_size // 2
    fundamental_bin = int(test_freq / output_rate * fft_size)
    mags2 = np.abs(spec[:half]) ** 2

    signal_power = 0.0
    for b in range(-3, 4):
        idx = fundamental_bin + b
        if 0 < idx < half:
            signal_power += mags2[idx]

    nyquist = output_rate / 2.0
    harmonic_bins = set()
    for h in range(2, 11):
        hf = test_freq * h
        if hf >= nyquist:
            break
        hb = int(hf / output_rate * fft_size)
        for b in range(-2, 3):
            harmonic_bins.add(hb + b)

    noise_power = 0.0
    for b in range(1, half):
        if fundamental_bin - 3 <= b <= fundamental_bin + 3:
            continue
        if b in harmonic_bins:
            continue
        noise_power += mags2[b]

    return float(10.0 * np.log10(signal_power + _EPS)
                 - 10.0 * np.log10(noise_power + _EPS))


@dataclasses.dataclass
class RippleResult:
    ripple_peak_peak: float
    max_deviation: float
    min_deviation: float
    frequencies: list
    levels: list


def passband_ripple(output: np.ndarray, output_rate: float, test_freqs,
                    fft_size: int = 16384) -> RippleResult:
    """Peak-to-peak level deviation across passband tones, in dB.

    Reference parity: measurePassbandRipple (quality_comparison_test.go:133-186).
    """
    spec = _windowed_fft(output, fft_size)
    half = fft_size // 2
    levels = []
    for freq in test_freqs:
        b = int(freq / output_rate * fft_size)
        peak = -200.0
        for d in range(-2, 3):
            idx = b + d
            if 0 < idx < half:
                peak = max(peak, 20.0 * np.log10(abs(spec[idx]) + _EPS))
        levels.append(peak)
    avg = float(np.mean(levels))
    devs = [lv - avg for lv in levels]
    return RippleResult(ripple_peak_peak=max(devs) - min(devs),
                        max_deviation=max(devs), min_deviation=min(devs),
                        frequencies=list(test_freqs), levels=levels)


def psd(signal: np.ndarray, rate: float, window_size: int = 8192):
    """Welch power spectral density in dB with Hann window, 50% overlap.

    Analysis analog of the reference's computePSD used by the
    anti-aliasing tests.
    """
    if len(signal) < window_size:
        window_size = max(256, 1 << (len(signal).bit_length() - 1))
    win = _hann(window_size)
    hop = window_size // 2
    acc = np.zeros(window_size // 2, dtype=np.float64)
    count = 0
    for start in range(0, len(signal) - window_size + 1, hop):
        seg = signal[start:start + window_size] * win
        spec = np.fft.fft(seg)
        acc += np.abs(spec[:window_size // 2]) ** 2
        count += 1
    if count == 0:
        count = 1
    acc /= count
    freqs = np.arange(window_size // 2) * rate / window_size
    return freqs, 10.0 * np.log10(acc + _EPS)


def peak_energy_db(freqs: np.ndarray, psd_db: np.ndarray,
                   f_low: float, f_high: float) -> float:
    """Peak PSD level within [f_low, f_high] (antialiasing_test.go:250-270)."""
    mask = (freqs >= f_low) & (freqs <= f_high)
    if not mask.any():
        return -200.0
    return float(psd_db[mask].max())


def antialias_attenuation(input_signal: np.ndarray, output: np.ndarray,
                          input_rate: float, output_rate: float,
                          window_size: int = 8192) -> float:
    """Anti-aliasing attenuation in dB for a downsampling conversion.

    Feed :func:`signals.alias_tones` as the input; aliases from
    [outNyq, inNyq] fold into [outRate - inNyq, outNyq] of the output.
    Attenuation = input alias-region peak - output alias-target peak.
    Reference parity: measureDownsamplingAntiAliasing
    (antialiasing_test.go:636-700).
    """
    in_nyq = input_rate / 2.0
    out_nyq = output_rate / 2.0
    in_freqs, in_psd = psd(input_signal, input_rate, window_size)
    out_freqs, out_psd = psd(output, output_rate, window_size)
    input_peak = peak_energy_db(in_freqs, in_psd, out_nyq + 500.0, in_nyq - 500.0)
    alias_low = max(output_rate - in_nyq, 100.0)
    output_peak = peak_energy_db(out_freqs, out_psd, alias_low, out_nyq)
    return input_peak - output_peak


def dc_gain(output: np.ndarray, skip_ratio: float = 0.25) -> float:
    """Steady-state mean of a DC response, skipping edge transients.

    Reference parity: measureDCGain (precision_comparison_test.go:443-454).
    """
    n = len(output)
    lo = int(n * skip_ratio)
    hi = n - lo
    if hi <= lo:
        lo, hi = 0, n
    return float(np.mean(output[lo:hi]))


def amplitude(output: np.ndarray, skip_ratio: float = 0.25) -> float:
    """Steady-state peak amplitude (precision_comparison_test.go:534-545)."""
    n = len(output)
    lo = int(n * skip_ratio)
    hi = n - lo
    if hi <= lo:
        lo, hi = 0, n
    return float(np.max(np.abs(output[lo:hi])))
