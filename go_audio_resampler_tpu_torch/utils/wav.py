"""WAV I/O: ctypes binding to the native C++ reader/writer, with a numpy
path.

Counterpart of the JAX package's ``utils/wav.py``.  The native library
(``native/wavio.cpp``, a copy of the JAX package's) streams normalized
float32 interleaved frames; it is built with g++ at first use into
``go_audio_resampler_tpu_torch/_build/`` (listed in ``.gitignore``), never
in the source tree, under a name that carries a digest of the source.
The numpy path implements the same RIFF subset (PCM 8/16/24/32 and
float32) where no compiler is there.  This is file I/O on the host; no
device is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import struct
import subprocess
import threading

import numpy as np

_NATIVE_SRC = (pathlib.Path(__file__).resolve().parent.parent / "native"
               / "wavio.cpp")
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
_LOCK = threading.Lock()
_lib = None
_lib_tried = False


def library_path() -> pathlib.Path:
    """Where the native library goes, keyed by its source."""
    digest = hashlib.sha256(_NATIVE_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libwavio-{digest}.so"


def make_flags() -> list[str]:
    """The compile flags of ``native/Makefile``'s library rule: its
    ``CXXFLAGS`` and the rule's own (``-shared``)."""
    text = (_NATIVE_SRC.parent / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", text, re.M).group(1)
    rule = re.search(r"\$\(CXXFLAGS\) (.*) -o \$@", text).group(1)
    return flags.split() + rule.split()


def _build(lib: pathlib.Path) -> None:
    """Compile ``native/wavio.cpp`` to ``lib`` with the Makefile's flags
    (atomically, so that processes building at once never load a
    half-written file)."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *make_flags(), "-o",
                        str(tmp), str(_NATIVE_SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


def _load_native():
    """Load (building if needed) the native wavio library; None where it
    cannot be built or loaded."""
    global _lib, _lib_tried
    with _LOCK:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.wav_read_open.restype = ctypes.c_void_p
        lib.wav_read_open.argtypes = [ctypes.c_char_p]
        lib.wav_read_info.restype = ctypes.c_int
        lib.wav_read_info.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_uint32)] * 3 + \
            [ctypes.POINTER(ctypes.c_uint64)]
        lib.wav_read_samples.restype = ctypes.c_int64
        lib.wav_read_samples.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_float),
                                         ctypes.c_int64]
        lib.wav_read_close.argtypes = [ctypes.c_void_p]
        lib.wav_write_open_fmt.restype = ctypes.c_void_p
        lib.wav_write_open_fmt.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                           ctypes.c_uint32, ctypes.c_uint32,
                                           ctypes.c_uint32]
        lib.wav_write_samples.restype = ctypes.c_int64
        lib.wav_write_samples.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_int64]
        lib.wav_write_close.restype = ctypes.c_int
        lib.wav_write_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _native(use_native: bool | None):
    """The native library where ``use_native`` allows it (None: where it
    loads); raises where ``use_native`` is True and it does not."""
    lib = _load_native() if use_native in (None, True) else None
    if use_native is True and lib is None:
        raise RuntimeError("native wavio library unavailable")
    return lib


class WavReader:
    """Streaming WAV reader yielding [frames, channels] float32 blocks."""

    def __init__(self, path: str, use_native: bool | None = None):
        self.path = str(path)
        self._lib = lib = _native(use_native)
        if lib is not None:
            self._h = lib.wav_read_open(self.path.encode())
            if not self._h:
                raise ValueError(f"cannot open WAV file: {path}")
            rate = ctypes.c_uint32()
            ch = ctypes.c_uint32()
            bits = ctypes.c_uint32()
            frames = ctypes.c_uint64()
            lib.wav_read_info(self._h, rate, ch, bits, frames)
            self.sample_rate = rate.value
            self.channels = ch.value
            self.bits = bits.value
            self.num_frames = frames.value
        else:
            self._open_numpy()

    # -- numpy path ----------------------------------------------------------

    def _open_numpy(self):
        data = pathlib.Path(self.path).read_bytes()
        if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            raise ValueError(f"cannot open WAV file: {self.path}")
        pos = 12
        fmt = None
        self._payload = None
        while pos + 8 <= len(data):
            cid = data[pos:pos + 4]
            (clen,) = struct.unpack_from("<I", data, pos + 4)
            body = data[pos + 8:pos + 8 + clen]
            if cid == b"fmt ":
                fmt = struct.unpack_from("<HHIIHH", body, 0)
            elif cid == b"data":
                self._payload = body
                break
            pos += 8 + clen + (clen & 1)
        if fmt is None or self._payload is None:
            raise ValueError(f"malformed WAV file: {self.path}")
        self._format, self.channels, self.sample_rate, _, _, self.bits = fmt
        frame_bytes = self.channels * self.bits // 8
        self.num_frames = len(self._payload) // frame_bytes
        self._pos = 0
        self._h = None

    def read(self, max_frames: int) -> np.ndarray:
        """Next block of [n, channels] float32 frames; empty at EOF."""
        if self._lib is not None:
            out = np.empty(max_frames * self.channels, dtype=np.float32)
            n = self._lib.wav_read_samples(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                max_frames)
            if n < 0:
                raise IOError("wav read error")
            return out[:n * self.channels].reshape(-1, self.channels)
        start = self._pos
        n = min(max_frames, self.num_frames - start)
        if n <= 0:
            return np.zeros((0, self.channels), np.float32)
        fb = self.channels * self.bits // 8
        raw = self._payload[start * fb:(start + n) * fb]
        self._pos += n
        if self._format == 3 and self.bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif self.bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif self.bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            v = np.where(v & 0x800000, v - (1 << 24), v)
            x = v.astype(np.float32) / 8388608.0
        elif self.bits == 32:
            x = (np.frombuffer(raw, dtype="<i4").astype(np.float64)
                 / 2147483648.0).astype(np.float32)
        elif self.bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        else:
            raise IOError(f"unsupported bit depth: {self.bits}")
        return x.reshape(-1, self.channels)

    def close(self):
        if self._lib is not None and self._h:
            self._lib.wav_read_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WavWriter:
    """Streaming WAV writer taking [frames, channels] float32 blocks.

    ``bits`` selects the sample encoding: 16/24/32 integer PCM, or the
    string ``"32f"`` for IEEE float32 (WAVE_FORMAT_IEEE_FLOAT, format tag
    3 with a fact chunk): float output passes samples through unscaled
    and unclamped, keeping headroom above full scale.
    """

    def __init__(self, path: str, sample_rate: int, channels: int,
                 bits: int | str = 16, use_native: bool | None = None):
        if bits in ("32f", "f32", "float32"):
            self.bits, self.fmt = 32, 3
        elif bits in (16, 24, 32):
            self.bits, self.fmt = int(bits), 1
        else:
            raise ValueError("bits must be 16, 24, 32, or '32f'")
        self.path = str(path)
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self._lib = lib = _native(use_native)
        if lib is not None:
            self._h = lib.wav_write_open_fmt(
                self.path.encode(), self.sample_rate, self.channels,
                self.bits, self.fmt)
            if not self._h:
                raise IOError(f"cannot create WAV file: {path}")
        else:
            self._chunks = []
            self._h = None

    def write(self, frames: np.ndarray) -> int:
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        if frames.ndim == 1:
            frames = frames[:, None]
        n = frames.shape[0]
        if self._lib is not None:
            wrote = self._lib.wav_write_samples(
                self._h,
                frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
            if wrote < 0:
                raise IOError("wav write error")
            return int(wrote)
        self._chunks.append(frames.copy())
        return n

    def close(self):
        if self._lib is not None:
            if self._h:
                self._lib.wav_write_close(self._h)
                self._h = None
            return
        # numpy path: assemble and write the whole file
        data = (np.concatenate(self._chunks, axis=0) if self._chunks
                else np.zeros((0, self.channels), np.float32))
        if self.fmt == 3:
            pcm = data.astype("<f4").tobytes()
            nframes = data.shape[0]
            hdr = b"RIFF" + struct.pack("<I", 50 + len(pcm)) + b"WAVE"
            hdr += b"fmt " + struct.pack("<IHHIIHHH", 18, 3, self.channels,
                                         self.sample_rate,
                                         self.sample_rate * self.channels * 4,
                                         self.channels * 4, 32, 0)
            hdr += b"fact" + struct.pack("<II", 4, nframes)
            hdr += b"data" + struct.pack("<I", len(pcm))
            pathlib.Path(self.path).write_bytes(hdr + pcm)
            return
        x = np.clip(data, -1.0, 1.0).reshape(-1)
        if self.bits == 16:
            pcm = np.rint(x * 32767.0).astype("<i2").tobytes()
        elif self.bits == 24:
            v = np.rint(x * 8388607.0).astype(np.int32)
            b = np.empty((len(v), 3), np.uint8)
            b[:, 0] = v & 0xFF
            b[:, 1] = (v >> 8) & 0xFF
            b[:, 2] = (v >> 16) & 0xFF
            pcm = b.tobytes()
        else:
            pcm = np.rint(x.astype(np.float64) * 2147483647.0)\
                .astype("<i4").tobytes()
        hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
        hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, self.channels,
                                     self.sample_rate,
                                     self.sample_rate * self.channels
                                     * self.bits // 8,
                                     self.channels * self.bits // 8,
                                     self.bits)
        hdr += b"data" + struct.pack("<I", len(pcm))
        pathlib.Path(self.path).write_bytes(hdr + pcm)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
