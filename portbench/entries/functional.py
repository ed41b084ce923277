"""``functional.resample``: one call on a batch of clips already on the
card, its output synchronised there (ingest inside a training step).

A request's clips are a contiguous [batch, n] view into a pool made from
the seed: the mix's ``pool_requests`` batches of the longest length, taken
in turn for a fixed length, or a view at an offset drawn from the seed for
a drawn length.  The first two warm-up requests of a drawn length take the
longest and the shortest length the mix can give; the rest follow the
sequence.  A batch holds the mix's ``batch`` clips, or, where the mix
gives ``batch_seconds`` in its place, as many clips of the request's
length as that much audio holds (a sampler that fills each batch to a
duration, as length-bucketing samplers do).

The check holds every request's output length to the reference's
canonical length, and for the sampled clips of each sampled request (one
from each of ``sample_streams`` equal slices of its batch, drawn from the
seed) compares the output with the reference's one-shot stream of that
clip.
"""

from __future__ import annotations

import math

import torch

from portbench import costs, generator
from portbench.harness import Verdict
from portbench.reference import resample as reference
from portbench.reference.design import Decimation


def canonical_length(filters, n: int) -> int:
    if isinstance(filters, Decimation):
        return reference.decimation_length(n, filters.factor,
                                           len(filters.coeffs))
    raise NotImplementedError(
        f"the reference has no one-shot length for {type(filters).__name__}")


class Driver:
    def __init__(self, ctx):
        from go_audio_resampler_tpu_torch import functional
        from go_audio_resampler_tpu_torch.api import QualityPreset
        c, t = ctx.config, ctx.traffic
        self.ctx = ctx
        self.functional = functional
        self.quality = QualityPreset[c["quality"]]
        self.length_of, longest, shortest = generator.lengths(
            t["lengths"], c["input_rate"], ctx.seed)
        if "batch_seconds" in t:
            budget = generator.samples(t["batch_seconds"], c["input_rate"])
            self.batch_of = lambda n: budget // n
            self.stride = budget
        else:
            batch = int(t["batch"])
            self.batch_of = lambda n: batch
            self.stride = batch * longest
        self.fixed = t["lengths"]["kind"] == "fixed"
        self.extremes = [] if self.fixed else [longest, shortest]
        self.warmup_requests = int(t["warmup_requests"])
        self.pool_requests = int(t["pool_requests"])
        self.pool = generator.noise((self.pool_requests * self.stride,),
                                    ctx.seed, 1, ctx.device)
        self.sample_streams = int(t["sample_streams"])
        self.wrong_lengths = 0
        self._clip = self._x = None

    def prepare(self, i: int) -> None:
        """Request ``i``'s clips: (offset into the pool, samples a clip,
        clips) and their view."""
        n = (self.extremes[i] if i < len(self.extremes)
             else self.length_of(i))
        b = self.batch_of(n)
        if self.fixed:
            off = (i % self.pool_requests) * self.stride
        else:
            room = self.pool.numel() - b * n
            off = int(generator.rng(self.ctx.seed, 4, i).integers(0, room + 1))
        self._clip = off, n, b
        self._x = self._view(self._clip)

    def _view(self, clip):
        off, n, b = clip
        return self.pool[off:off + b * n].view(b, n)

    def _rows(self, b: int) -> list[int]:
        """The sampled clips of a batch of ``b``: the same slices of every
        batch, drawn from the seed."""
        return generator.stratified_rows(b, self.sample_streams,
                                         self.ctx.seed)

    def call(self, i: int):
        x, self._x = self._x, None
        return self.functional.resample(
            x, self.ctx.config["input_rate"], self.ctx.config["output_rate"],
            quality=self.quality, device=self.ctx.device)

    def finish(self, ret) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def record(self, i: int, ret):
        _, n, b = self._clip
        want = canonical_length(self.ctx.filters, n)
        self.wrong_lengths += int(tuple(ret.shape) != (b, want))
        ops, nbytes = costs.work(self.ctx.filters, n, want)
        return n * b, ops * b, nbytes * b

    def sample(self, i: int, ret):
        return self._clip, ret[self._rows(self._clip[2])].clone()

    def release(self) -> None:
        """Nothing to free: the program keeps no object of this entry's,
        only its one-shot caches of a few MB."""

    def verify(self, kept: dict) -> Verdict:
        refs, errors = {}, {}
        for i, (clip, y) in kept.items():
            x = self._view(clip)[self._rows(clip[2])]
            if clip not in refs:
                refs[clip] = reference.decimate(x, self.ctx.filters)
            ref = refs[clip]
            if self.ctx.control == "tf32":
                y = reference.decimate(x, self.ctx.filters, True)
            if y.shape != ref.shape:
                errors[i] = math.inf
                continue
            errors[i] = float((y.double() - ref).abs().max()
                              / ref.abs().max())
        worst = max(errors.values(), default=math.nan)
        return Verdict({"max_rel_err": worst,
                        "length_errors": float(self.wrong_lengths)},
                       errors, self.wrong_lengths)
