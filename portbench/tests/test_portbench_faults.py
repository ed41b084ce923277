"""A whole run on the CPU at a small size, the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath, for
each fault that a cell can have, ``correct`` comes out false.

The cells run on one chip, so no exchange between chips can be left out.
"""

import pytest
import torch

from portbench.tests.small import CELLS, STREAMING, run


@pytest.fixture
def engine_step(monkeypatch):
    """Replace ``EngineCore._step`` (the step that every engine entry
    runs) by ``wrap(step)``."""
    from go_audio_resampler_tpu_torch import EngineCore

    def install(wrap):
        monkeypatch.setattr(EngineCore, "_step", wrap(EngineCore._step))
    return install


@pytest.fixture
def resample(monkeypatch):
    from go_audio_resampler_tpu_torch import functional

    def install(wrap):
        monkeypatch.setattr(functional, "resample", wrap(functional.resample))
    return install


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r["checks"])[0] == "max_rel_err"
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", STREAMING)
def test_state_returned_unchanged(cell, engine_step):
    """A step that hands back the state it was given."""
    engine_step(lambda step: lambda self, state, x: (
        state, *step(self, state, x)[1:]))
    assert not run(cell)["correct"]


def _half(y):
    y = y.clone() if isinstance(y, torch.Tensor) else y.copy()
    y[y.shape[0] // 2:] = 0
    return y


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, engine_step, resample):
    """Only the first half of the streams or clips computed."""
    if cell in STREAMING:
        def wrap(step):
            def half(self, state, x):
                state, y, n = step(self, state, x)
                return state, _half(y), n
            return half
        engine_step(wrap)
    else:
        resample(lambda f: lambda *a, **k: _half(f(*a, **k)))
    r = run(cell)
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell, engine_step,
                                                resample):
    """One output sample of every stream moved by 1e-3 of full scale, in
    every step or call."""
    def alter(y):
        y = y.clone()
        y[:, y.shape[1] // 2] += 1e-3
        return y
    if cell in STREAMING:
        def wrap(step):
            def altered(self, state, x):
                state, y, n = step(self, state, x)
                return state, alter(y), n
            return altered
        engine_step(wrap)
    else:
        resample(lambda f: lambda *a, **k: alter(f(*a, **k)))
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", STREAMING)
def test_outputs_held_back_are_missing(cell, engine_step):
    """A step that emits none of its outputs leaves due outputs missing."""
    def wrap(step):
        def held(self, state, x):
            state, y, _ = step(self, state, x)
            return state, y[:, :0], 0
        return held
    engine_step(wrap)
    r = run(cell)
    assert not r["correct"] and r["checks"]["missing_outputs"]["value"] > 0


@pytest.mark.parametrize("cell", ["whisper16.clips", "whisper16.varlen"])
def test_a_short_output_is_a_length_error(cell, resample):
    resample(lambda f: lambda *a, **k: f(*a, **k)[:, :-1])
    r = run(cell)
    assert not r["correct"] and r["checks"]["length_errors"]["value"] > 0
