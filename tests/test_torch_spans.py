"""The port's spans (``utils/spans.py``): recorded, named and nested as
documented while ``torch.profiler`` runs, absent and free when it does
not, and without effect on any output."""

import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from go_audio_resampler_tpu_torch import (EngineCore, Quality,
                                          TimeMajorEngine, functional,
                                          plan_engine)
from go_audio_resampler_tpu_torch.utils import spans

toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")

BLOCK = 882
STREAMS = 3


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the ``gar.*`` spans as
    (name, start_ns, end_ns), ordered by start, an enclosing span first)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("gar.")]
    return out, sorted(found, key=lambda s: (s[1], -s[2]))


def _parent(found, i):
    """The innermost span that encloses ``found[i]``, or None."""
    _, a, b = found[i]
    for name, pa, pb in reversed(found[:i]):
        if pa <= a and b <= pb:
            return name
    return None


def _children(found, name):
    return [found[i][0] for i in range(len(found))
            if _parent(found, i) == name]


def _signal(n, seed=0, streams=STREAMS):
    return np.random.default_rng(seed).standard_normal(
        (streams, n)).astype(np.float32)


def _engine():
    return EngineCore(plan_engine(44100.0, 48000.0, Quality.HIGH),
                      batch=STREAMS, block=BLOCK, dtype=torch.float32,
                      device="cpu")


#: name -> (a call returning a fresh output, the spans it records in a
#: profiler)
ENTRIES = {
    "process": (lambda: _engine().process(_signal(2 * BLOCK)),
                {spans.ENGINE_PROCESS, spans.ENGINE_FIFO, spans.ENGINE_H2D,
                 spans.ENGINE_STEP, spans.K1, spans.ENGINE_D2H,
                 spans.ENGINE_EMIT}),
    "process_device": (
        lambda: _engine().process_device(torch.from_numpy(
            _signal(2 * BLOCK))),
        {spans.ENGINE_PROCESS_DEVICE, spans.ENGINE_H2D, spans.ENGINE_STEP,
         spans.K1, spans.ENGINE_EMIT}),
    "flush": (lambda: _flushed(_engine()),
              {spans.ENGINE_H2D, spans.ENGINE_STEP, spans.K1,
               spans.ENGINE_D2H, spans.ENGINE_EMIT}),
    "functional_decimate": (
        lambda: functional.resample(_signal(1500), 48000, 16000,
                                    device="cpu"),
        {spans.FUNCTIONAL_RESAMPLE, spans.ONESHOT_APPLY, spans.K1}),
    "oneshot_general": (
        lambda: toneshot.oneshot(plan_engine(44100.0, 48001.0, Quality.LOW),
                                 _signal(600, streams=2), device="cpu"),
        {spans.ONESHOT_AUX, spans.ONESHOT_DESIGN, spans.ONESHOT_UPLOAD,
         spans.ONESHOT_APPLY, spans.K3}),
    "tmajor": (
        lambda: TimeMajorEngine(plan_engine(44100.0, 48000.0, Quality.HIGH),
                                batch=STREAMS, block=BLOCK,
                                device="cpu").process_device(
            torch.from_numpy(_signal(2 * BLOCK).T.copy())),
        {spans.K2}),
}


def _flushed(eng):
    eng.process(_signal(BLOCK + 100))
    return eng.flush()


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_leave_outputs_bit_identical(entry):
    """The same call gives the same bits under a profiler and without one,
    and records its spans there."""
    call, want = ENTRIES[entry]
    plain = call()
    traced, found = _profiled(call)
    assert np.array_equal(np.asarray(traced), np.asarray(plain))
    assert want <= {name for name, _, _ in found}
    assert {name for name, _, _ in found} <= set(spans.NAMES)


@pytest.mark.parametrize("entry, children", [
    ("process", [spans.ENGINE_FIFO, spans.ENGINE_FIFO, spans.ENGINE_H2D,
                 spans.ENGINE_STEP, spans.ENGINE_D2H, spans.ENGINE_EMIT,
                 spans.ENGINE_EMIT]),
    ("process_device", [spans.ENGINE_H2D, spans.ENGINE_STEP,
                        spans.ENGINE_EMIT]),
])
def test_engine_step_spans_nest(entry, children):
    """A call of two blocks: one entry span around the FIFO's write and
    read, the H2D, the step with K1 inside it, the D2H and the emits, in
    that order; nothing outside the entry span."""
    _, found = _profiled(ENTRIES[entry][0])
    top = [found[i][0] for i in range(len(found))
           if _parent(found, i) is None]
    assert top == [spans.ENGINE_PROCESS if entry == "process"
                   else spans.ENGINE_PROCESS_DEVICE]
    assert _children(found, top[0]) == children
    assert _children(found, spans.ENGINE_STEP) == [spans.K1]


@pytest.mark.parametrize("rates", [(48000, 16000), (44100, 48000)],
                         ids=["decimate", "rational"])
def test_oneshot_aux_span_counts_cache_misses(rates):
    """Two calls at one length: the set-up (design and upload inside it)
    is built and spanned on the first call only, as the cache's misses
    count it."""
    functional._aux.cache_clear()
    x = _signal(1234, seed=1)
    counts = []
    for _ in range(2):
        misses = functional._aux.cache_info().misses
        _, found = _profiled(lambda: functional.resample(
            x, *rates, device="cpu"))
        counts.append(sum(1 for s in found if s[0] == spans.ONESHOT_AUX))
        assert counts[-1] == functional._aux.cache_info().misses - misses
        top = [found[i][0] for i in range(len(found))
               if _parent(found, i) is None]
        assert top == [spans.FUNCTIONAL_RESAMPLE]
        if counts[-1]:
            assert _parent(found, [s[0] for s in found].index(
                spans.ONESHOT_AUX)) == spans.FUNCTIONAL_RESAMPLE
            assert _children(found, spans.ONESHOT_AUX) == [
                spans.ONESHOT_DESIGN, spans.ONESHOT_UPLOAD]
    assert counts == [1, 0]


def _refuse(*args, **kwargs):
    raise AssertionError("record_function built with no profiler running")


@pytest.mark.parametrize("name", spans.NAMES)
def test_span_is_the_shared_null_context_without_a_profiler(name,
                                                            monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    assert spans.span(name) is spans.span(spans.K1)
    with spans.span(name) as inside:
        assert inside is None


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_record_function_without_a_profiler(entry, monkeypatch):
    """Every instrumented path runs with ``record_function`` refused."""
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    ENTRIES[entry][0]()


def test_span_records_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span(spans.K1) is not spans.span(spans.K2)


def test_names_are_unique_and_prefixed():
    assert len(set(spans.NAMES)) == len(spans.NAMES) == 16
    assert all(n.startswith("gar.") for n in spans.NAMES)
