"""The port's spans: named ranges at each layer boundary, on the profiler's
own clock.

To see them, wrap any call in ``torch.profiler.profile`` (as
``resample_wav -profile`` does): the ``gar.*`` spans appear among its host
events, in the same trace and on the same clock as the card's kernels and
copies.  They are ``gar.engine.process``, ``gar.engine.process_device``,
``gar.engine.fifo``, ``gar.engine.h2d``, ``gar.engine.step``,
``gar.engine.d2h``, ``gar.engine.emit``, ``gar.functional.resample``,
``gar.oneshot.aux``, ``gar.oneshot.design``, ``gar.oneshot.upload``,
``gar.oneshot.apply``, ``gar.banded.prepare``, ``gar.k1``, ``gar.k2`` and
``gar.k3``, each named below with what it covers.

A span is a ``torch.profiler.record_function`` range while a profiler is
recording, and one shared null context otherwise: no flag, option or
environment variable turns them on, and with no profiler running a span
builds no ``record_function``.  The profiler holds the ranges and writes
them when it stops; the program keeps no buffer of its own.

A span's parent is the span that encloses it on the same thread, and a
request's spans share its entry span: :data:`ENGINE_PROCESS`,
:data:`ENGINE_PROCESS_DEVICE` or :data:`FUNCTIONAL_RESAMPLE`.
"""

from __future__ import annotations

import contextlib

import torch

#: ``EngineCore.process``: one call, numpy in and out.
ENGINE_PROCESS = "gar.engine.process"
#: ``EngineCore.process_device``: one call, tensors on the engine's device.
ENGINE_PROCESS_DEVICE = "gar.engine.process_device"
#: The host FIFO's copies and a step's staging: ``SampleFIFO.write``, and
#: each block's copy into the input staging buffer, from the FIFO or
#: straight from the caller's array.
ENGINE_FIFO = "gar.engine.fifo"
#: ``EngineCore._to_device`` and ``_run_block``: the host-to-device copy
#: of a block.
ENGINE_H2D = "gar.engine.h2d"
#: ``EngineCore._step``: the step's host enqueue (the carry's ``cat``, the
#: kernel launch, the slices).
ENGINE_STEP = "gar.engine.step"
#: A step's output copied back to numpy (``_run_block``: through the
#: pinned output buffer on the card; the prefilter's ``.cpu().numpy()``),
#: with its wait for the step's kernels.
ENGINE_D2H = "gar.engine.d2h"
#: The ramp drop, canonical limit and head rows (``_CanonicalStream._emit``,
#: shared by the host and device paths) and the ``np.concatenate`` of a
#: call's outputs.
ENGINE_EMIT = "gar.engine.emit"
#: ``functional.resample``: one call.
FUNCTIONAL_RESAMPLE = "gar.functional.resample"
#: ``oneshot._oneshot_aux``: the one-shot's set-up for a (plan, length);
#: under ``functional.resample`` it runs only on a miss of its cache.
ONESHOT_AUX = "gar.oneshot.aux"
#: The operator's design on the host (``_decim_matrix``,
#: ``_fused_rational_matrix`` with ``superframe``, ``_general_matrices``,
#: ``_cubic_matrices``).
ONESHOT_DESIGN = "gar.oneshot.design"
#: The operator's upload (``_matrix_t``, ``_upload``, ``fftstage.spectrum``).
ONESHOT_UPLOAD = "gar.oneshot.upload"
#: ``oneshot._oneshot_apply``: the one-shot's device work.
ONESHOT_APPLY = "gar.oneshot.apply"
#: ``banded.prepare``: R's limbs and band table for K1 and K2.
BANDED_PREPARE = "gar.banded.prepare"
#: The kernel wrappers past their argument checks (``ops/fused.py``,
#: ``ops/tmajor.py``, ``ops/general.py``): the launch on the card, the
#: plain version on the CPU.
K1 = "gar.k1"
K2 = "gar.k2"
K3 = "gar.k3"

#: Every span name above.
NAMES = (ENGINE_PROCESS, ENGINE_PROCESS_DEVICE, ENGINE_FIFO, ENGINE_H2D,
         ENGINE_STEP, ENGINE_D2H, ENGINE_EMIT, FUNCTIONAL_RESAMPLE,
         ONESHOT_AUX, ONESHOT_DESIGN, ONESHOT_UPLOAD, ONESHOT_APPLY,
         BANDED_PREPARE, K1, K2, K3)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` in a running profiler: a
    ``torch.profiler.record_function`` while one records, else a shared
    null context, which costs a small part of what entering a
    ``record_function`` does even with no profiler running."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
