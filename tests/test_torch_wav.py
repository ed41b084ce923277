"""The port's WAV I/O (``go_audio_resampler_tpu_torch/utils/wav.py``)
against the JAX package's ``utils/wav.py``.

For each mix of writers (the JAX and the port's, native and numpy) and
each encoding (16/24/32-bit PCM, ``32f``), the files are byte-identical,
and the port's readers return arrays equal to the JAX readers'.  The JAX
package's ``TestWavIO`` cases (tests/test_streaming_extras.py) run
against the port.  The port's native library is built from its own copy
of ``wavio.cpp`` into ``go_audio_resampler_tpu_torch/_build/``.
"""

import numpy as np
import pytest

from go_audio_resampler_tpu.utils import wav as jw
from go_audio_resampler_tpu_torch.utils import wav as tw

ENCODINGS = [16, 24, 32, "32f"]
WRITERS = [("jax", True), ("jax", False), ("torch", True), ("torch", False)]


def _writer(pkg, native):
    return (jw if pkg == "jax" else tw).WavWriter, native


def _signal(seed=3, n=1237, channels=2, scale=0.9):
    rng = np.random.default_rng(seed)
    sig = rng.uniform(-scale, scale, size=(n, channels)).astype(np.float32)
    sig[:4] = [[1.0, -1.0], [1.5, -1.5], [0.0, 0.5], [-0.25, 1e-7]][:4]
    return sig


def _write(path, cls, native, bits, sig, rate=44100):
    w = cls(path, rate, sig.shape[1], bits, use_native=native)
    w.write(sig[:500])
    w.write(sig[500:])
    w.close()


def test_native_library_built_from_the_port(tmp_path):
    lib = tw._load_native()
    assert lib is not None
    path = tw.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "go_audio_resampler_tpu_torch"
    assert tw._NATIVE_SRC.read_bytes() == (
        tw._NATIVE_SRC.parents[2] / "go_audio_resampler_tpu" / "native"
        / "wavio.cpp").read_bytes()


def test_build_uses_the_makefile_rule(tmp_path, monkeypatch):
    """The loader compiles with the flags ``make`` would use for
    ``native/Makefile``'s library rule."""
    import os
    import subprocess
    env = {k: v for k, v in os.environ.items()
           if k not in ("CXX", "CXXFLAGS", "MAKEFLAGS")}
    dry = subprocess.run(["make", "-n", "-B", "libwavio.so"],
                         cwd=tw._NATIVE_SRC.parent, env=env, check=True,
                         capture_output=True, text=True).stdout.split()
    want = dry[1:dry.index("-o")]
    assert "-shared" in want and tw.make_flags() == want
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()

    monkeypatch.setattr(tw.subprocess, "run", run)
    monkeypatch.delenv("CXX", raising=False)
    tw._build(tmp_path / "lib.so")
    assert seen[0][1:seen[0].index("-o")] == want


@pytest.mark.parametrize("bits", ENCODINGS)
@pytest.mark.parametrize("writer", WRITERS, ids=lambda w: f"{w[0]}-"
                         f"{'native' if w[1] else 'numpy'}")
def test_files_byte_identical_and_reads_equal(tmp_path, bits, writer):
    """The port's writers, native and numpy, write the JAX native
    writer's bytes; each reader of the port returns the JAX readers'
    arrays (and header fields) for every file."""
    sig = _signal()
    ref = tmp_path / "ref.wav"
    _write(ref, jw.WavWriter, True, bits, sig)
    path = tmp_path / "out.wav"
    cls, native = _writer(*writer)
    _write(path, cls, native, bits, sig)
    assert path.read_bytes() == ref.read_bytes()
    for rnative in (True, False):
        want = jw.WavReader(path, use_native=rnative)
        got = tw.WavReader(path, use_native=rnative)
        assert (got.sample_rate, got.channels, got.bits, got.num_frames) == (
            want.sample_rate, want.channels, want.bits, want.num_frames)
        a, b = got.read(700), want.read(700)
        c, d = got.read(10000), want.read(10000)
        got.close()
        want.close()
        assert np.array_equal(a, b) and np.array_equal(c, d)
        assert a.dtype == np.float32 and a.shape == (700, 2)


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_pcm_depths_read_as_jax(tmp_path, bits):
    """Files of every PCM depth the readers take (8-bit written by hand),
    read equal by both packages' numpy and native readers."""
    import struct
    n, ch = 301, 1
    rng = np.random.default_rng(bits)
    if bits == 8:
        pcm = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
        hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, 8000, 8000, 1, 8)
        hdr += b"data" + struct.pack("<I", len(pcm))
        (tmp_path / "x.wav").write_bytes(hdr + pcm)
    else:
        _write(tmp_path / "x.wav", jw.WavWriter, False, bits,
               rng.uniform(-1, 1, (n, ch)).astype(np.float32))
    for native in (True, False):
        got = tw.WavReader(tmp_path / "x.wav", use_native=native).read(n)
        want = jw.WavReader(tmp_path / "x.wav", use_native=native).read(n)
        assert got.shape == (n, ch) and np.array_equal(got, want)


# -- the JAX package's TestWavIO cases, against the port -------------------

@pytest.mark.parametrize("bits,tol", [(16, 1e-4), (24, 3e-7), (32, 1e-7)])
@pytest.mark.parametrize("native", [True, False])
def test_roundtrip(tmp_path, bits, tol, native):
    t = np.arange(1000) / 44100
    sig = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                    -0.5 * np.sin(2 * np.pi * 440 * t)], axis=1)
    p = tmp_path / f"t{bits}.wav"
    w = tw.WavWriter(p, 44100, 2, bits, use_native=native)
    w.write(sig.astype(np.float32))
    w.close()
    r = tw.WavReader(p, use_native=native)
    assert (r.sample_rate, r.channels, r.bits) == (44100, 2, bits)
    got = r.read(5000)
    r.close()
    assert got.shape == sig.shape
    assert np.abs(got - sig).max() < tol


@pytest.mark.parametrize("native", [True, False])
def test_clamping(tmp_path, native):
    p = tmp_path / "clip.wav"
    w = tw.WavWriter(p, 8000, 1, 16, use_native=native)
    w.write(np.array([[2.0], [-2.0]], np.float32))
    w.close()
    got = tw.WavReader(p, use_native=native).read(10)
    assert np.abs(got).max() <= 1.0


@pytest.mark.parametrize("native", [True, False])
def test_bad_file(tmp_path, native):
    p = tmp_path / "junk.wav"
    p.write_bytes(b"this is not a wav file at all.....")
    with pytest.raises(ValueError):
        tw.WavReader(p, use_native=native)


@pytest.mark.parametrize("bits", [12, "24f"])
def test_invalid_bits(tmp_path, bits):
    with pytest.raises(ValueError):
        tw.WavWriter(tmp_path / "x.wav", 8000, 1, bits)


@pytest.mark.parametrize("wnative", [True, False])
@pytest.mark.parametrize("rnative", [True, False])
def test_float32_roundtrip_exact(tmp_path, wnative, rnative):
    """IEEE-float output (bits='32f') is bit-exact and unclamped,
    including values above full scale, across both implementations."""
    rng = np.random.RandomState(7)
    sig = (rng.normal(size=(777, 2)) * 1.5).astype(np.float32)
    p = tmp_path / "f.wav"
    w = tw.WavWriter(p, 96000, 2, "32f", use_native=wnative)
    w.write(sig[:300])
    w.write(sig[300:])
    w.close()
    r = tw.WavReader(p, use_native=rnative)
    assert (r.sample_rate, r.channels, r.bits) == (96000, 2, 32)
    assert r.num_frames == 777
    got = r.read(2000)
    r.close()
    assert np.array_equal(got, sig)
    assert np.abs(got).max() > 1.0


def test_use_native_true_raises_without_the_library(tmp_path, monkeypatch):
    """``use_native=True`` refuses where the library cannot be built;
    ``None`` takes the numpy path there."""
    monkeypatch.setattr(tw, "_load_native", lambda: None)
    with pytest.raises(RuntimeError, match="native"):
        tw.WavWriter(tmp_path / "x.wav", 8000, 1, 16, use_native=True)
    w = tw.WavWriter(tmp_path / "x.wav", 8000, 1, 16)
    assert w._lib is None
    w.write(np.zeros((3, 1), np.float32))
    w.close()
    assert tw.WavReader(tmp_path / "x.wav").read(10).shape == (3, 1)


def test_package_data_lists_the_sources():
    """Every file the port's builds read at first use (the kernels'
    sources and headers, the WAV library's source and Makefile) is in
    ``pyproject.toml``'s package data, so an installed copy builds."""
    import fnmatch
    import pathlib
    import tomllib
    root = pathlib.Path(__file__).resolve().parent.parent
    data = tomllib.loads((root / "pyproject.toml").read_text())
    data = data["tool"]["setuptools"]["package-data"]
    pkg = root / "go_audio_resampler_tpu_torch"
    wanted = ([p for p in (pkg / "ops" / "csrc").iterdir()]
              + [pkg / "native" / "wavio.cpp", pkg / "native" / "Makefile"])
    assert len(wanted) >= 6
    for path in wanted:
        owners = [(name, globs) for name, globs in data.items()
                  if (pkg.parent / name.replace(".", "/")) in path.parents]
        assert any(fnmatch.fnmatch(
            str(path.relative_to(pkg.parent / name.replace(".", "/"))), g)
            for name, globs in owners for g in globs), path
