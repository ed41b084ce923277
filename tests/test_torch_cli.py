"""The port's CLI (``go_audio_resampler_tpu_torch/cli/``) against the JAX
package's, on the same WAV files.

The port runs with ``-device cpu`` (float64 engine, as the JAX CLI on
its CPU backend under x64); single-file outputs agree within one LSB
(16-bit PCM) and one float32 ulp (``32f``), batch mode (the float32
one-shot in both) within 2e-5.  The error exits, ``resample_info`` and
``analyze_filter`` match the JAX tools (``resample_info``'s backend line
names the device).
"""

import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.cli import analyze_filter as j_analyze
from go_audio_resampler_tpu.cli import resample_info as j_info
from go_audio_resampler_tpu.cli import resample_wav as j_wav
from go_audio_resampler_tpu.utils.wav import WavReader
from go_audio_resampler_tpu_torch.cli import analyze_filter as t_analyze
from go_audio_resampler_tpu_torch.cli import resample_info as t_info
from go_audio_resampler_tpu_torch.cli import resample_wav as t_wav
from go_audio_resampler_tpu_torch.utils.wav import WavWriter

CPU = ["-device", "cpu"]


def _stereo(path, n, seed, rate=44100, bits=16):
    """A tone on channel 0 and noise on channel 1, written as ``bits``."""
    t = np.arange(n) / rate
    rng = np.random.default_rng(seed)
    sig = np.stack([0.5 * np.sin(2 * np.pi * 1000.0 * t),
                    0.25 * rng.uniform(-1, 1, n)], axis=1)
    w = WavWriter(path, rate, 2, bits, use_native=False)
    w.write(sig.astype(np.float32))
    w.close()


def _read(path):
    r = WavReader(path, use_native=False)
    return r, r.read(r.num_frames)


@pytest.mark.parametrize("quality", ["medium", "high"])
@pytest.mark.parametrize("bits", ["16", "32f"])
def test_single_file_matches_jax(tmp_path, quality, bits):
    inp = tmp_path / "in.wav"
    _stereo(inp, 22050, seed=1)
    args = [str(inp), "-rate", "48000", "-quality", quality, "-bits", bits]
    assert j_wav.run([args[0], str(tmp_path / "j.wav")] + args[1:]) == 0
    assert t_wav.run([args[0], str(tmp_path / "t.wav")] + args[1:]
                     + CPU) == 0
    (rj, yj), (rt, yt) = _read(tmp_path / "j.wav"), _read(tmp_path / "t.wav")
    assert (rt.sample_rate, rt.channels, rt.bits, rt.num_frames) == (
        rj.sample_rate, rj.channels, rj.bits, rj.num_frames)
    assert rt.num_frames > 22050 * 48000 // 44100 - 100
    if bits == "16":
        lsb = np.abs(np.rint(yt * 32768.0) - np.rint(yj * 32768.0)).max()
        assert lsb <= 1
    else:
        ulp = np.spacing(np.maximum(np.abs(yt), np.abs(yj)))
        assert np.all(np.abs(yt - yj) <= ulp)


def test_batch_mode_matches_jax(tmp_path):
    """Three stereo files of different lengths through -outdir: each
    output within 2e-5 of the JAX CLI's, with its canonical length."""
    paths = []
    for i, n in enumerate([2205, 4410, 1103]):
        paths.append(tmp_path / f"f{i}.wav")
        _stereo(paths[-1], n, seed=10 + i)
    files = [str(p) for p in paths]
    flags = ["-rate", "48000", "-bits", "32f"]
    assert j_wav.run(files + ["-outdir", str(tmp_path / "j")] + flags) == 0
    assert t_wav.run(files + ["-outdir", str(tmp_path / "t")] + flags
                     + CPU) == 0
    for p in paths:
        (rj, yj), (rt, yt) = (_read(tmp_path / "j" / p.name),
                              _read(tmp_path / "t" / p.name))
        assert rt.num_frames == rj.num_frames and yt.shape == yj.shape
        assert np.abs(yt - yj).max() <= 2e-5


def test_error_exits(tmp_path, capsys):
    """Missing input, a name collision, a wrong positional count: the
    JAX CLI's exit codes; -dispatch tune now runs (exit 0) and writes the
    -dispatch auto output (it resolves to 'auto' on the CPU)."""
    missing = [str(tmp_path / "none.wav"), str(tmp_path / "o.wav")]
    assert t_wav.run(missing + CPU) == j_wav.run(missing) == 1
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        _stereo(tmp_path / sub / "same.wav", 100, seed=0)
    clash = [str(tmp_path / "a" / "same.wav"),
             str(tmp_path / "b" / "same.wav"), "-outdir",
             str(tmp_path / "out")]
    capsys.readouterr()
    assert t_wav.run(clash + CPU) == j_wav.run(clash) == 1
    assert capsys.readouterr().err.count("collision") == 2
    assert t_wav.run([str(tmp_path / "x.wav")] + CPU) == \
        j_wav.run([str(tmp_path / "x.wav")]) == 2
    for mode in ("tune", "auto"):
        assert t_wav.run([str(tmp_path / "a" / "same.wav"),
                          str(tmp_path / f"{mode}.wav"), "-dispatch", mode]
                         + CPU) == 0
    assert ((tmp_path / "tune.wav").read_bytes()
            == (tmp_path / "auto.wav").read_bytes())


def test_no_gpu_without_device_cpu(tmp_path, capsys, monkeypatch):
    """The default device is the card: without one the CLI exits 1 and
    says so, in single-file and batch mode."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _stereo(tmp_path / "in.wav", 100, seed=0)
    assert t_wav.run([str(tmp_path / "in.wav"),
                      str(tmp_path / "o.wav")]) == 1
    assert t_wav.run([str(tmp_path / "in.wav"), "-outdir",
                      str(tmp_path / "d")]) == 1
    assert capsys.readouterr().err.count("-device cpu") == 2
    with pytest.raises(RuntimeError, match="CUDA"):
        t_info.run([])


def test_profile_writes_a_trace(tmp_path, capsys):
    _stereo(tmp_path / "in.wav", 4410, seed=2)
    assert t_wav.run([str(tmp_path / "in.wav"), str(tmp_path / "o.wav"),
                      "-quality", "low", "-profile", str(tmp_path / "tr"),
                      "-v"] + CPU) == 0
    assert (tmp_path / "tr" / "resample_wav.trace.json").stat().st_size
    out = capsys.readouterr().out
    assert "realtime" in out and "100%" in out


@pytest.mark.parametrize("argv", [
    [], ["-in", "48000", "-out", "44100", "-quality", "low", "-channels",
         "2"], ["-in", "96000", "-out", "48000", "-quality", "veryhigh"],
])
def test_resample_info_matches_jax(argv, capsys):
    """Line for line the JAX tool's, the backend line naming the port's
    device."""
    assert j_info.run(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert t_info.run(argv + CPU) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        if w.startswith("backend:"):
            assert g == "backend:      torch:cpu"
        else:
            assert g == w


@pytest.mark.parametrize("argv", [
    [], ["-phases", "8", "-taps", "16"],
    ["-phases", "64", "-taps", "24", "-cutoff", "0.4", "-attenuation", "100",
     "-interp", "linear", "-show", "3"], ["-interp", "none", "-show", "0"],
])
def test_analyze_filter_matches_jax(argv, capsys):
    assert j_analyze.run(argv) == 0
    want = capsys.readouterr().out
    assert t_analyze.run(argv) == 0
    assert capsys.readouterr().out == want
