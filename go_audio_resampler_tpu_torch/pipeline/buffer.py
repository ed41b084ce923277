"""Batched inter-stage sample FIFO (host side).

Stand-in for the reference's mutex-guarded auto-growing RingBuffer
(internal/pipeline/buffer.go:12-172): the device step needs no queues,
but the *host* side of the engine still needs an elastic FIFO for
input that does not fill a whole block.  This one carries all channels on a
leading batch axis and grows geometrically like the reference
(buffer.go:107-143).
"""

from __future__ import annotations

import numpy as np


class SampleFIFO:
    """Auto-growing FIFO of [batch, n] sample frames.

    API parity with the reference RingBuffer: write / read / read_into /
    available / reset (buffer.go:38-172).  Not thread-safe: the
    engine has no concurrent producers (the reference's mutex guarded
    goroutine fan-in, which batching replaces).
    """

    def __init__(self, batch: int, capacity: int = 8192,
                 dtype=np.float64):
        self.batch = batch
        self.dtype = np.dtype(dtype)
        self._buf = np.zeros((batch, max(capacity, 1)), dtype=self.dtype)
        self._start = 0
        self._len = 0

    def available(self) -> int:
        return self._len

    def write(self, frames: np.ndarray) -> None:
        frames = np.asarray(frames, dtype=self.dtype)
        if frames.ndim == 1:
            frames = frames[None, :]
        if frames.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {frames.shape[0]}")
        n = frames.shape[1]
        if n == 0:
            return
        need = self._len + n
        if need > self._buf.shape[1]:
            new_cap = self._buf.shape[1]
            while new_cap < need:
                new_cap *= 2  # buffer.go growth factor
            new_buf = np.zeros((self.batch, new_cap), dtype=self.dtype)
            new_buf[:, :self._len] = self._peek(self._len)
            self._buf = new_buf
            self._start = 0
        # compact then append (host copy; cheap relative to device work)
        if self._start + need > self._buf.shape[1]:
            self._buf[:, :self._len] = self._peek(self._len)
            self._start = 0
        self._buf[:, self._start + self._len:self._start + need] = frames
        self._len = need

    def _peek(self, n: int) -> np.ndarray:
        return self._buf[:, self._start:self._start + n]

    def read(self, n: int) -> np.ndarray:
        n = min(n, self._len)
        out = self._peek(n).copy()
        self._start += n
        self._len -= n
        if self._len == 0:
            self._start = 0
        return out

    def read_all(self) -> np.ndarray:
        return self.read(self._len)

    def read_into(self, dst: np.ndarray) -> int:
        """Fill dst[:, :n] from the FIFO; returns n (buffer.go:145-172)."""
        n = min(dst.shape[-1], self._len)
        src = self._peek(n)
        if dst.ndim == 1:
            dst[:n] = src[0, :n]
        else:
            dst[:, :n] = src[:, :n]
        self._start += n
        self._len -= n
        if self._len == 0:
            self._start = 0
        return n

    def snapshot(self) -> np.ndarray:
        """Non-consuming copy of the queued frames (for checkpointing)."""
        return self._peek(self._len).copy()

    def reset(self) -> None:
        self._start = 0
        self._len = 0
