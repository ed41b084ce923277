"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and compiles
on its own with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``go_audio_resampler_tpu_torch/_build/`` (listed in ``.gitignore``).
The library's file name carries a digest of its source and of every local
header it includes (``#include "..."``, e.g. ``banded_mma.cuh``), so an
edited kernel or header is rebuilt and a stale library is never loaded.  Nothing here runs at
import time; a machine without ``nvcc`` fails only when a kernel is asked
for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each kernel built by
#: this process, by source name.
PTXAS_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the CUDA kernels are built from source at first use")
    return path


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the headers it includes with quotes (files
    beside it), recursively."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes, keyed by its source
    and its headers."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    process (or None) and the temporary output path."""
    lib = library_path(name)
    if lib.exists():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    PTXAS_LOG[name] = log
    os.replace(tmp, library_path(name))      # atomic: no half-written .so


def build_all(names) -> None:
    """Compile the given sources in parallel (one nvcc each, all started
    together) and load them."""
    with _LOCK:
        started = [(n, *_start(n)) for n in names if n not in _LIBS]
        errors = []
        for name, proc, tmp in started:       # wait for every nvcc
            try:
                _finish(name, proc, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for name, _, _ in started:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib
