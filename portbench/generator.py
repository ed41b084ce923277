"""The one traffic generator: inputs, request sizes and samples, all from
the seed.

A traffic mix is a JSON file of parameters (``portbench/traffic/<mix>.
json``); this module turns it, the configuration and ``--seed`` into what
an entry needs.  The same seed gives the same inputs, sizes and samples.

- Input pools are uniform noise in [-1, 1) made on the run's device by a
  ``torch.Generator`` seeded from the seed, in one call a pool.
- Request sizes are durations in the mix, turned into samples at the
  configuration's input rate.  A ``log_uniform`` length is stratified:
  each block of ``strata`` requests holds one length from each of
  ``strata`` equal slices of the log range, in an order and at a place
  within its slice drawn from the seed, so every seed asks for the same
  amount of work within a block and nearly every request has a new length.
- Which streams and which requests a run checks are drawn from the seed:
  one stream from each of ``k`` equal slices of the batch, and a uniform
  sample of the window's requests (a reservoir).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_MASK = (1 << 64) - 1


def seed64(seed: int) -> int:
    """Any whole number as a 64-bit seed."""
    return int(seed) & SEED_MASK


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A host generator for one purpose (``stream``) of the seed."""
    return np.random.default_rng([seed64(seed), *stream])


def noise(shape, seed: int, stream: int, device) -> torch.Tensor:
    """float32 uniform noise in [-1, 1) of ``shape`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed) ^ (stream * 0x9E3779B97F4A7C15 & SEED_MASK))
    t = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return t.mul_(2.0).sub_(1.0)


def samples(seconds: float, rate: float) -> int:
    """``seconds`` at ``rate`` as a whole number of samples; refuses a
    duration that is not one."""
    n = seconds * rate
    if abs(n - round(n)) > 1e-6:
        raise ValueError(f"{seconds} s at {rate} Hz is not a whole number "
                         "of samples")
    return int(round(n))


def stratified_rows(rows: int, k: int, seed: int) -> list[int]:
    """One row from each of ``k`` equal slices of ``rows``, drawn from the
    seed."""
    k = min(k, rows)
    g = rng(seed, 1)
    edges = [rows * i // k for i in range(k + 1)]
    return [int(g.integers(edges[i], edges[i + 1])) for i in range(k)]


def lengths(spec: dict, rate: float, seed: int):
    """The function ``i -> samples`` of request ``i`` for the mix's
    ``lengths`` entry, and the longest and shortest it can give."""
    kind = spec["kind"]
    if kind == "fixed":
        n = samples(spec["seconds"], rate)
        return (lambda i: n), n, n
    if kind != "log_uniform":
        raise ValueError(f"unknown length distribution {kind!r}")
    lo, hi = math.log(spec["min_seconds"]), math.log(spec["max_seconds"])
    strata = int(spec["strata"])
    blocks: dict[int, list[int]] = {}

    def length(i: int) -> int:
        block, pos = divmod(i, strata)
        if block not in blocks:
            g = rng(seed, 2, block)
            u = (g.permutation(strata) + g.random(strata)) / strata
            blocks.clear()
            blocks[block] = [int(round(math.exp(lo + v * (hi - lo)) * rate))
                             for v in u]
        return blocks[block][pos]

    return (length, int(round(spec["max_seconds"] * rate)),
            int(round(spec["min_seconds"] * rate)))


class Reservoir:
    """A uniform sample of at most ``size`` of a stream of requests,
    drawn from the seed (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.seen = 0
        self.kept: dict[int, object] = {}
        self._slots: list[int] = []
        self._rng = rng(seed, 3)

    def slot(self, i: int) -> bool:
        """Whether request ``i`` is to be kept; makes room for it."""
        self.seen += 1
        if len(self._slots) < self.size:
            self._slots.append(i)
            return True
        j = int(self._rng.integers(0, self.seen))
        if j >= self.size:
            return False
        del self.kept[self._slots[j]]
        self._slots[j] = i
        return True
