"""The streaming entries: ``EngineCore`` over a batch of continuous streams.

Shared by ``engine_host`` (``process``: numpy in and out) and
``engine_device`` (``process_device`` on tensors already on the card).
Each request is the next block of every stream, read in turn from a pool
of ``pool_requests`` blocks made from the seed, so every stream is
continuous; the warm-up requests are the streams' first blocks.

The check follows the streams' state through every step: for the sampled
streams of each sampled request it compares the outputs the step emitted,
at their place in the stream, with the reference's outputs there; and
for every request it counts the outputs that were due before the request
(the reference's count of outputs whose input had all been fed) and had
still not come when it returned.
"""

from __future__ import annotations

import collections
import math

import torch

from portbench import costs, generator
from portbench.harness import Verdict
from portbench.reference import resample as reference


class EngineDriver:
    """A closed loop of blocks through one ``EngineCore``."""

    on_device = False

    def __init__(self, ctx):
        from go_audio_resampler_tpu_torch import EngineCore, Quality, \
            plan_engine
        c, t = ctx.config, ctx.traffic
        self.ctx = ctx
        self.streams = int(t["streams"])
        self.width = generator.samples(t["request_seconds"], c["input_rate"])
        plan = plan_engine(float(c["input_rate"]), float(c["output_rate"]),
                           Quality[c["quality"]])
        self.eng = EngineCore(plan, batch=self.streams, block=self.width,
                              dtype=torch.float32, dispatch=c["dispatch"],
                              precision=ctx.tier, device=ctx.device)
        mult = self.eng.device_chunk_multiple
        if mult is None or self.width % mult or self.eng.block != self.width:
            raise ValueError(
                f"a request of {self.width} samples is not one step of the "
                f"engine (block {self.eng.block}, chunk multiple {mult})")
        self.pool_requests = int(t["pool_requests"])
        pool = generator.noise((self.pool_requests, self.streams, self.width),
                               ctx.seed, 1, ctx.device)
        self.rows = generator.stratified_rows(self.streams,
                                              int(t["sample_streams"]),
                                              ctx.seed)
        # The sampled streams' whole input, for the reference.
        self.inputs = pool[:, self.rows, :].permute(1, 0, 2).reshape(
            len(self.rows), -1).double()
        self.pool = pool if self.on_device else pool.cpu().numpy()
        del pool
        self.warmup_requests = int(t["warmup_requests"])
        # Steps that may still run on the card when a request returns.
        self.in_flight = int(t.get("in_flight", 0)) if self.on_device else 0
        self._running = collections.deque()
        #: Whether each step ends with its output ready (on the host, or
        #: synchronised on the card); the harness reads it.
        self.synchronised = self.in_flight == 0
        self.fed = self.emitted = self.missing = 0
        self.span = (0, 0)

    def prepare(self, i: int) -> None:
        self._block = self.pool[i % self.pool_requests]

    def call(self, i: int):
        block, self._block = self._block, None
        if self.on_device:
            return self.eng.process_device(block)
        return self.eng.process(block)

    def finish(self, ret) -> None:
        if not self.on_device or self.ctx.device.type != "cuda":
            return
        if self.synchronised:
            torch.cuda.synchronize(self.ctx.device)
            return
        done = torch.cuda.Event()
        done.record()
        self._running.append(done)
        if len(self._running) > self.in_flight:
            self._running.popleft().synchronize()

    def record(self, i: int, ret):
        n_out = int(ret.shape[1])
        due = reference.due(self.ctx.filters, self.fed)
        self.span = (self.emitted, self.emitted + n_out)
        self.emitted += n_out
        self.missing = max(self.missing, due - self.emitted)
        self.fed += self.width
        ops, nbytes = costs.work(self.ctx.filters, self.width, n_out)
        return (self.width * self.streams, ops * self.streams,
                nbytes * self.streams)

    def sample(self, i: int, ret):
        rows = ret[self.rows]
        return self.span, (rows.clone() if self.on_device else rows.copy())

    def release(self) -> None:
        del self.eng, self.pool

    def verify(self, kept: dict) -> Verdict:
        period = self.inputs.shape[1]

        def x_of(a, b):
            idx = torch.arange(a, b, device=self.inputs.device) % period
            return self.inputs[:, idx]

        errors = {}
        for i, ((j0, j1), y) in kept.items():
            if j1 == j0:
                continue
            ref = reference.stream(x_of, self.ctx.filters, j0, j1)
            if self.ctx.control == "tf32":
                y = reference.stream(x_of, self.ctx.filters, j0, j1, True)
            y = torch.as_tensor(y).to(ref.device, torch.float64)
            errors[i] = float((y - ref).abs().max() / ref.abs().max())
        worst = max(errors.values(), default=math.nan)
        return Verdict({"max_rel_err": worst,
                        "missing_outputs": float(self.missing)},
                       errors, int(self.missing > 0))
