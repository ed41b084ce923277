"""Stream-batch data parallelism over ``torch.distributed``.

PyTorch counterpart of the JAX package's ``parallel/mesh.py``.  Streams
are independent, so scaling across cards is pure data parallelism on the
leading batch axis; no sample crosses ranks.

The JAX module is single-controller: one host holds the whole [S, n]
batch and ``shard_map`` runs one program on each device's rows.  Here the
program is SPMD, one process a card (``torchrun`` and the like):

- a 1-D ``DeviceMesh`` named ``"streams"`` (:func:`make_mesh`);
- each rank runs the port's serial engines on its own
  ``batch_per_device`` streams, on ``cuda:{local_rank}`` (or the CPU);
- what an entry point returns on the device is a ``DTensor`` with the
  placement ``Shard(0)`` (the rank's rows as its local shard); host
  results are the global batch, gathered from every rank;
- the only collectives are ``all_reduce`` (MAX and SUM) on the mesh's
  group: a global peak and global stream statistics.

Each step runs on local tensors; only what an entry point returns is
wrapped in a ``DTensor`` (``from_local`` costs host time).  Inputs may be
given as the global batch (a numpy array or tensor of
``batch_per_device * mesh.size()`` rows, of which each rank takes its
own) or as a ``DTensor`` sharded on rows.
"""

from __future__ import annotations

import os
import types
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from ..engine.oneshot import _oneshot_aux, _oneshot_apply
from ..engine.streaming import EngineCore, _torch_dtype, pipelined_stream
from ..engine.variable import VariableRateResampler
from ..ops.precision import dot_precision

STREAM_AXIS = "streams"

#: Bound on a collective's wait, so that a rank that fails does not leave
#: the others waiting for ever.
TIMEOUT = timedelta(seconds=60)


def make_mesh(n_devices: int | None = None,
              device_type: str = 'cuda') -> DeviceMesh:
    """1-D mesh over the stream-batch axis, one rank a device.

    Uses the caller's process group (e.g. ``torchrun``'s).  Where none is
    set up and the size is 1, sets up a one-rank group on an in-memory
    store: ``nccl`` on the card, ``gloo`` on the CPU (``device_type=
    'cpu'``).  A size above 1 with no group raises; ``n_devices`` other
    than the group's size raises.
    """
    if device_type not in ('cuda', 'cpu'):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass "
                           "device_type='cpu' to run on the CPU")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh: a mesh of {n_devices} ranks needs a process "
                "group; start one process a device (e.g. torchrun) and "
                "call torch.distributed.init_process_group first")
        kw = {}
        if device_type == 'cuda':
            kw['device_id'] = torch.device('cuda', torch.cuda.current_device())
        dist.init_process_group('nccl' if device_type == 'cuda' else 'gloo',
                                store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT, **kw)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {size} ranks")
    if device_type == 'cuda':
        torch.cuda.set_device(_local_rank())
    return init_device_mesh(device_type, (size,),
                            mesh_dim_names=(STREAM_AXIS,))


def _local_rank() -> int:
    """This process's card: ``LOCAL_RANK`` where the launcher sets it,
    else the rank modulo the cards on the host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's streams: ``cuda:{local_rank}`` or the
    CPU."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', _local_rank())
    return torch.device('cpu')


class _Shards:
    """This rank's rows of a global batch of ``batch_per_device *
    mesh.size()`` streams, and the way back."""

    def __init__(self, mesh: DeviceMesh, batch_per_device: int):
        self.mesh = mesh
        self.batch_per_device = int(batch_per_device)
        self.size = mesh.size()
        self.global_batch = self.batch_per_device * self.size
        lo = mesh.get_local_rank(STREAM_AXIS) * self.batch_per_device
        self.rows = slice(lo, lo + self.batch_per_device)
        self.group = mesh.get_group(STREAM_AXIS)
        self.device = rank_device(mesh)

    def local(self, x, batch_axis: int = 0):
        """The rank's rows of ``x``: a ``DTensor``'s local shard, the
        rank's slice of an array or tensor that holds the global batch on
        ``batch_axis``; anything else (the rank's own rows, a 1-D
        stream to broadcast) as it is."""
        if isinstance(x, DTensor):
            return x.to_local()
        if np.ndim(x) >= 2 and x.shape[batch_axis] == self.global_batch:
            index = [slice(None)] * np.ndim(x)
            index[batch_axis] = self.rows
            return x[tuple(index)]
        return x

    def check(self, x) -> None:
        """Raise unless ``x`` is a row-sharded ``DTensor``, a 1-D stream
        or a 2-D global batch."""
        if isinstance(x, DTensor) or np.ndim(x) == 1:
            return
        if np.ndim(x) != 2 or x.shape[0] != self.global_batch:
            raise ValueError(f"expected {self.global_batch} streams (the "
                             f"global batch), got {tuple(np.shape(x))}")

    def wrap(self, y: torch.Tensor) -> DTensor:
        """The rank's rows ``y`` as the global ``DTensor``, ``Shard(0)``."""
        return DTensor.from_local(y, self.mesh, [Shard(0)], run_check=False)

    def gather(self, y: np.ndarray) -> np.ndarray:
        """Every rank's host rows ``y``, in rank order (the global batch);
        every rank's ``y`` has the same width."""
        if self.size == 1:
            return y
        t = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=0).cpu().numpy()

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t


def sharded_oneshot(plan, x, mesh: DeviceMesh, dtype=torch.float32):
    """One-shot resample with the stream axis sharded across the mesh.

    ``x`` is the global [S, n] batch (S divisible by the mesh size) or a
    ``DTensor`` sharded on rows.  Each rank runs the port's one-shot on
    its rows (K1 or K3 on the card) with its own host-designed operators;
    no collective.  Returns a ``DTensor``, ``Shard(0)``.
    """
    size = mesh.size()
    s_total = x.shape[0]
    if s_total % size:
        raise ValueError(f"sharded_oneshot: {s_total} streams do not "
                         f"divide over {size} ranks")
    sh = _Shards(mesh, s_total // size)
    xl = torch.as_tensor(sh.local(x)).to(device=sh.device,
                                         dtype=_torch_dtype(dtype))
    tier = dot_precision(None)
    aux = _oneshot_aux(plan, int(xl.shape[1]), xl.dtype, xl.device, tier)
    return sh.wrap(_oneshot_apply(plan, xl, aux, tier))


def sharded_stream_step(plan, mesh: DeviceMesh, batch_per_device: int,
                        block: int, dtype=torch.float32):
    """A sharded streaming step of the two-stage engine.

    Returns ``(init_state, step, block)``: ``block`` is the effective
    input length a step (the serial engine's: rounded up to the fused
    operator's period, or halved until the walk's bound holds);
    ``init_state()`` gives the rank's state (its rows, on its device);
    ``step(state, x)`` takes a [S_total, block] input (or a row-sharded
    ``DTensor``) and returns ``(state', y, n, peak)``: ``y`` a ``DTensor``
    (``Shard(0)``) of which ``y[:, :n]`` are the core's outputs, ``n`` a
    host int, and ``peak`` the global max|y|, a 0-d tensor after a MAX
    ``all_reduce`` (the only cross-rank traffic), never read back inside
    the step.

    The step is the rank's serial ``EngineCore.core_fn`` on its rows:
    exact-rational plans run the fused banded step (K1 on the card), whose
    stream includes the leading ramp that a consumer trims as
    ``EngineCore`` does; other plans run the poly walk (the prestage, K1
    on the card, then the polyphase emit).
    """
    if plan.kind != 'two_stage':
        raise ValueError("sharded_stream_step currently builds the flagship "
                         "two_stage topology")
    if plan.aa_taps and not plan.is_rational_exact:
        raise ValueError("sharded_stream_step does not yet support "
                         "strict-antialias plans with a non-exact walk "
                         "(exact-rational plans fold the aa prefilter "
                         "into the fused matrix)")
    sh = _Shards(mesh, batch_per_device)
    eng = EngineCore(plan, batch=batch_per_device, block=block, dtype=dtype,
                     device=sh.device)
    core = eng.core_fn()

    def step(state, x):
        sh.check(x)
        state, y, n = core(state, eng._to_device(sh.local(x)))
        # A walk step that emits nothing (the history still filling) has
        # a peak of 0.
        peak = y.abs().amax() if y.numel() else y.new_zeros(())
        return state, sh.wrap(y), n, sh.all_reduce(peak, dist.ReduceOp.MAX)

    return eng._init_state, step, eng.block


class _ShardedStreams:
    """The global-batch entry points of a sharded streaming engine over
    the rank's serial one (the next class in the method order): host
    input and output are the global batch; device input is the global
    batch or a row-sharded ``DTensor``, device output a ``DTensor``
    (``Shard(0)``)."""

    def _put(self, arr, batch_axis: int = 0):
        """The rank's rows of ``arr`` (see ``_Shards.local``)."""
        return self._shards.local(arr, batch_axis)

    def process(self, x) -> np.ndarray:
        self._shards.check(x)
        return self._shards.gather(super().process(self._put(x)))

    def flush(self) -> np.ndarray:
        return self._shards.gather(super().flush())

    def process_device(self, x) -> DTensor:
        self._shards.check(x)
        return self._shards.wrap(super().process_device(self._put(x)))

    def flush_device(self) -> DTensor:
        return self._shards.wrap(super().flush_device())

    def stream(self, chunks, out: str = 'host'):
        """Pipelined streaming of global-batch chunks (the serial
        engine's ``stream``): yields the global batch on the host
        (``out='host'``) or ``DTensor`` s (``out='device'``)."""
        if out not in ('host', 'device'):
            raise ValueError(f"out must be 'host' or 'device', got {out!r}")
        mult = self.device_chunk_multiple
        if mult is None:
            # process()/flush() only: the serial stream calls the global
            # entry points above.
            yield from super().stream(chunks, out)
            return
        serial = types.SimpleNamespace(
            batch=self.batch, np_dtype=self.np_dtype, device=self.device,
            process=super().process, process_device=super().process_device,
            flush_device=super().flush_device)

        def local_chunks():
            for x in chunks:
                self._shards.check(x)
                yield self._put(np.asarray(x))

        for y in pipelined_stream(serial, local_chunks(), out, mult):
            yield (self._shards.gather(y) if out == 'host'
                   else self._shards.wrap(y))


class ShardedEngineCore(_ShardedStreams, EngineCore):
    """``EngineCore`` with the stream batch sharded across a mesh.

    Every topology of the serial engine (the fused banded steps, the
    walk, cubic, dft_up, strict antialias and banded composites), with
    its transient drop, canonical trim and flush.  Each rank runs the
    serial engine on its ``batch_per_device`` streams on its device; the
    engine's state has those rows only.  Streams are independent, so the
    emitted stream equals a serial ``EngineCore``'s with the same plan,
    block and dtype; with one rank it launches what the serial engine
    launches on the same rows.

    ``process``/``flush`` take and return the global host batch
    (``batch_per_device * mesh.size()`` rows); ``process_device``,
    ``flush_device`` and ``stream(out='device')`` return ``DTensor`` s
    with ``Shard(0)``.  ``batch`` is the rank's row count.

    With ``dispatch='tune'`` every rank tunes its serial engine at
    ``batch_per_device`` rows, then pins rank 0's result, sent with one
    ``broadcast_object_list``, so that every rank runs one lowering (the
    JAX package's single controller pins one for the mesh).  Only rank 0
    writes the tune cache.
    """

    def __init__(self, plan, mesh: DeviceMesh, batch_per_device: int = 1,
                 block: int = 2048, dtype=torch.float32,
                 dispatch: str = 'auto', precision: str = 'auto'):
        self.mesh = mesh
        self._shards = _Shards(mesh, batch_per_device)
        super().__init__(plan, batch=batch_per_device, block=block,
                         dtype=dtype, dispatch=dispatch, precision=precision,
                         device=self._shards.device)

    def _tune_dispatch(self, persist: bool = True) -> str:
        first = self.mesh.get_local_rank(STREAM_AXIS) == 0
        pin = [super()._tune_dispatch(persist=persist and first)]
        group = self._shards.group
        dist.broadcast_object_list(pin, src=dist.get_global_rank(group, 0),
                                   group=group)
        self.tune_record['pin'] = pin[0]
        return pin[0]


def global_stream_stats(x, mesh: DeviceMesh):
    """Global RMS and peak over a stream batch sharded across the mesh, by
    SUM and MAX ``all_reduce``; ``x`` is the global [S, n] batch (S
    divisible by the mesh size) or a row-sharded ``DTensor``.  Returns
    (rms, peak) as 0-d tensors on the rank's device."""
    size = mesh.size()
    if x.shape[0] % size:
        raise ValueError(f"global_stream_stats: {x.shape[0]} streams do not "
                         f"divide over {size} ranks")
    sh = _Shards(mesh, x.shape[0] // size)
    xl = torch.as_tensor(sh.local(x)).to(sh.device)
    sums = torch.stack([(xl * xl).sum(),
                        torch.tensor(float(xl.numel()), dtype=xl.dtype,
                                     device=xl.device)])
    sh.all_reduce(sums, dist.ReduceOp.SUM)
    peak = sh.all_reduce(xl.abs().max(), dist.ReduceOp.MAX)
    return torch.sqrt(sums[0] / sums[1]), peak


class ShardedVariableRateResampler(_ShardedStreams, VariableRateResampler):
    """Variable-rate resampler with the batch axis sharded across a mesh.

    Every rank runs the same host walk (the window indices and fractions
    are the same for every stream); the carry, the prestage carry and the
    blocks are the rank's rows (the ``_put`` hook), on its device.  The
    same model as :class:`ShardedEngineCore`.
    """

    def __init__(self, max_ratio: float, io_ratio: float = 1.0, *,
                 mesh: DeviceMesh, batch_per_device: int = 1, **kwargs):
        self.mesh = mesh
        self._shards = _Shards(mesh, batch_per_device)
        super().__init__(max_ratio, io_ratio, batch=batch_per_device,
                         device=self._shards.device, **kwargs)
