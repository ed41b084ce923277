"""The port's examples (``go_audio_resampler_tpu_torch/examples/``) against
the JAX repo's ``examples/`` on the CPU.

Each JAX example is loaded from its file and run as its ``__main__``
runs it; spies on the JAX package's calls record the values it printed
(its ``main`` returns none).  The port's ``main(device='cpu')`` returns
them.  Lengths are equal; values agree within 1e-12 of the peak where
both sides compute in float64 and 2e-5 where they compute in float32;
the printed lines are equal, but for the text after the backend,
device or platform that a line names.
"""

import importlib.util
import inspect
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_audio_resampler_tpu as jgar
from go_audio_resampler_tpu import api as japi
from go_audio_resampler_tpu import parallel as jparallel
from go_audio_resampler_tpu.engine import streaming as jstreaming
from go_audio_resampler_tpu.engine import tmajor as jtmajor
from go_audio_resampler_tpu.engine import variable as jvariable
from go_audio_resampler_tpu_torch.examples import (
    NAMES, basic, device_serving, hq_and_time_major, ml_ingest_training,
    sharded, variable_rate)

ROOT = pathlib.Path(__file__).resolve().parent.parent
F64, F32 = 1e-12, 2e-5
#: Where a printed line names the backend, device or platform; the text
#: before it must still be equal.
PLATFORM = re.compile(r"backend: |rows on |^mesh: \d+ x ")


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spy(monkeypatch, owner, name: str) -> list:
    """Record ``(args, result)`` of every call of ``owner.name`` (each
    item of a generator it returns) while the test runs."""
    calls, real = [], getattr(owner, name)

    def items(args, gen):
        for item in gen:
            calls.append((args, item))
            yield item

    def spy(*args, **kw):
        out = real(*args, **kw)
        if inspect.isgenerator(out):
            return items(args, out)
        calls.append((args, out))
        return out

    monkeypatch.setattr(owner, name, spy)
    return calls


def _results(calls) -> list:
    return [np.asarray(out) for _, out in calls]


def _close(got, want, tol: float) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _printed(capsys, run) -> tuple[list[str], object]:
    """What ``run()`` printed, as lines, and what it returned."""
    capsys.readouterr()
    out = run()
    return capsys.readouterr().out.splitlines(), out


def _same_lines(port: list[str], ref: list[str]) -> None:
    assert len(port) == len(ref), (port, ref)
    for got, want in zip(port, ref):
        m, n = PLATFORM.search(got), PLATFORM.search(want)
        if n:
            assert m and got[:m.end()] == want[:n.end()], (got, want)
        else:
            assert got == want


def test_every_example_is_ported():
    assert sorted(NAMES) == sorted(p.stem for p in (ROOT / "examples").glob(
        "*.py"))
    for name in NAMES:
        mod = importlib.import_module(
            f"go_audio_resampler_tpu_torch.examples.{name}")
        assert inspect.signature(mod.main).parameters[
            "device"].default == "cuda"


def test_basic(capsys, monkeypatch):
    mono = _spy(monkeypatch, jgar, "resample_mono")
    oracle = _spy(monkeypatch, jgar, "oneshot")
    steps = (_spy(monkeypatch, japi.Resampler, "process"),
             _spy(monkeypatch, japi.Resampler, "flush"))
    vr = (_spy(monkeypatch, jvariable.VariableRateResampler, "process"),
          _spy(monkeypatch, jvariable.VariableRateResampler, "flush"))
    mod = _jax_example("basic")
    ref, _ = _printed(capsys, lambda: (mod.main(),
                                        mod.variable_rate_glissando()))
    lines, out = _printed(capsys, lambda: basic.main(device="cpu"))
    _same_lines(lines, ref)
    assert "backend: torch:cpu" in lines[2]
    # float64 on both sides (the conftest's x64).
    _close(out["oneshot"], _results(mono)[0], F64)
    _close(out["streamed"], np.concatenate(_results(steps[0])
                                           + _results(steps[1])), F64)
    _close(out["oracle"], _results(oracle)[0][0], F64)
    _close(out["glissando"], np.concatenate(_results(vr[0]) + _results(
        vr[1]), axis=1), F32)


def test_device_serving(capsys, monkeypatch, tmp_path):
    mod = _jax_example("device_serving")
    # The JAX script checkpoints to a fixed path; keep its file in this
    # test's own directory.
    ckpt = tmp_path / "serving_ckpt.npz"
    for name in ("save_stream_state", "load_stream_state"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda eng, _path, real=real: real(eng, ckpt))
    feats = _spy(monkeypatch, mod, "toy_ingest")
    hosted = _spy(monkeypatch, jstreaming.EngineCore, "stream")
    ref, _ = _printed(capsys, mod.main)
    assert ckpt.is_file()
    lines, out = _printed(capsys, lambda: device_serving.main(device="cpu"))
    _same_lines(lines, ref)
    _close(out["features"], np.concatenate(_results(feats), axis=1), F32)
    _close(out["stream"], np.concatenate(_results(hosted), axis=1), F32)
    assert (out["samples_in"], out["samples_out"]) == (142848, 47166)


def test_hq_and_time_major(capsys, monkeypatch):
    mod = _jax_example("hq_and_time_major")
    thd = _spy(monkeypatch, mod, "thd")
    steps = (_spy(monkeypatch, jtmajor.TimeMajorEngine, "process_device"),
             _spy(monkeypatch, jtmajor.TimeMajorEngine, "flush_device"))

    def jax_main():
        print("HQ inter-phase mode (non-exact ratio 44.1k -> 48,001):")
        mod.hq_interp_demo()
        print("Time-major device-resident serving (44.1k -> 48k, 8 ch):")
        mod.time_major_demo()

    ref, _ = _printed(capsys, jax_main)
    lines, out = _printed(capsys, lambda: hq_and_time_major.main(
        device="cpu"))
    # The hq_interp THD is float32 rounding noise (near -155 dB), which
    # each package's order of summation sets: its line holds the value
    # below -150 dB on both sides and is otherwise equal.
    hq = 2
    assert "hq_interp" in lines[hq] and "hq_interp" in ref[hq]
    for line in (lines[hq], ref[hq]):
        assert float(re.search(r"THD = +(\S+) dB", line)[1]) < -150
    strip = re.compile(r"THD = +\S+ dB")
    assert strip.sub("", lines[hq]) == strip.sub("", ref[hq])
    _same_lines(lines[:hq] + lines[hq + 1:], ref[:hq] + ref[hq + 1:])
    for key, (args, _) in zip(("default", "hq"), thd):
        _close(out[key], args[0], F32)
        assert len(out[key]) == len(args[0]) == 48003
    assert abs(out["thd_default_db"] - thd[0][1]) < 0.01
    _close(out["time_major"], np.concatenate(
        [y for y in _results(steps[0]) + _results(steps[1]) if y.shape[0]]),
        F32)


def test_ml_ingest_training_first_step():
    """One training step on the same batch: the port's loss, gradients
    and updated parameters within 1e-5 relative of the JAX example's
    ``train_step``."""
    mod = _jax_example("ml_ingest_training")
    assert ml_ingest_training.N_OUT == mod.N_OUT
    rng = np.random.default_rng(0)
    t = np.arange(mod.FIR_TAPS) - mod.FIR_TAPS // 2
    true_fir = (np.sinc(t / 3.0) * np.hanning(mod.FIR_TAPS)).astype(
        np.float32)
    head = rng.normal(size=(mod.N_OUT, mod.FEATS)).astype(np.float32) * 0.02
    x = rng.normal(size=(mod.BATCH, mod.N_IN)).astype(np.float32)
    xf = np.stack([np.convolve(r, true_fir, mode="same") for r in x])
    # A target that the resampled true front end does not give exactly,
    # so that the head's gradient is not zero.
    y = (np.asarray(jgar.resample(jnp.asarray(xf), mod.RATE_IN,
                                  mod.RATE_OUT)) @ head
         + rng.normal(size=(mod.BATCH, mod.FEATS)).astype(np.float32) * 0.01)
    fir0 = np.zeros(mod.FIR_TAPS, np.float32)
    fir0[mod.FIR_TAPS // 2] = 1.0
    params = {"fir": jnp.asarray(fir0), "head": jnp.asarray(head)}
    loss, grads = jax.value_and_grad(mod.loss_fn)(params, jnp.asarray(x),
                                                  jnp.asarray(y))
    stepped, step_loss = mod.train_step(params, jnp.asarray(x),
                                        jnp.asarray(y))

    head_given = head.copy()
    model = ml_ingest_training.IngestModel(head, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=ml_ingest_training.LR)
    got = ml_ingest_training.loss_fn(model, torch.as_tensor(x),
                                     torch.as_tensor(y))
    got.backward()
    assert got.item() == pytest.approx(float(loss), rel=1e-5)
    assert got.item() == pytest.approx(float(step_loss), rel=1e-5)
    for name in ("fir", "head"):
        _close(getattr(model, name).grad, grads[name], 1e-5)
    opt.step()
    for name in ("fir", "head"):
        _close(getattr(model, name).detach(), stepped[name], 1e-5)
    # The optimizer's in-place step leaves the caller's array alone.
    np.testing.assert_array_equal(head, head_given)


def test_ml_ingest_training(capsys, monkeypatch):
    mod = _jax_example("ml_ingest_training")
    steps = _spy(monkeypatch, mod, "train_step")
    ref, _ = _printed(capsys, mod.main)
    lines, out = _printed(capsys, lambda: ml_ingest_training.main(
        device="cpu"))
    _same_lines(lines, ref)
    l0, l1 = map(float, re.search(r"loss: (\S+) -> (\S+)", ref[0]).groups())
    assert l1 < 0.2 * l0
    assert out["loss_40"] < 0.2 * out["loss_0"]
    assert out["loss_0"] == pytest.approx(l0, abs=1e-6)
    assert out["loss_40"] == pytest.approx(float(steps[-1][1][1]), rel=1e-4)
    assert len(steps) == 40
    for name in ("fir", "head"):
        _close(out[name], steps[-1][1][0][name], F32)


def test_sharded(capsys, monkeypatch):
    mod = _jax_example("sharded")
    # The port's mesh is its process group, here one rank: give the JAX
    # example a mesh of one device too, so the sizes agree.
    monkeypatch.setattr(mod, "jax", types.SimpleNamespace(
        devices=lambda: jax.devices()[:1]))
    oneshot = _spy(monkeypatch, mod, "sharded_oneshot")
    steps = (_spy(monkeypatch, jparallel.ShardedEngineCore, "process"),
             _spy(monkeypatch, jparallel.ShardedEngineCore, "flush"))
    ref, _ = _printed(capsys, mod.main)
    lines, out = _printed(capsys, lambda: sharded.main(device="cpu"))
    assert ref[0] == lines[0] == "mesh: 1 x cpu"
    # The maxdiff line is each package's own float32 rounding; both
    # examples assert it below 1e-4.
    _same_lines(lines[:-1], ref[:-1])
    assert lines[-1].startswith("sharded streaming vs one-shot maxdiff: ")
    _close(out["oneshot"], _results(oneshot)[0], F32)
    _close(out["streamed"], np.concatenate(_results(steps[0])
                                           + _results(steps[1]), axis=1),
           F32)
    assert not torch.distributed.is_initialized()


def test_variable_rate(capsys, monkeypatch):
    blocks = (_spy(monkeypatch, jvariable.VariableRateResampler, "process"),
              _spy(monkeypatch, jvariable.VariableRateResampler, "flush"))
    mod = _jax_example("variable_rate")
    ref, _ = _printed(capsys, mod.main)
    lines, out = _printed(capsys, lambda: variable_rate.main(device="cpu"))
    _same_lines(lines, ref)
    want = np.concatenate([np.atleast_2d(b)[0] for b in _results(blocks[0])
                           + _results(blocks[1])])
    assert len(out["y"]) == len(want) == 239697
    _close(out["y"], want, F32)


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_the_card_without_one(name, monkeypatch):
    """``main()`` runs on the card by default: without one it raises, and
    does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(
        f"go_audio_resampler_tpu_torch.examples.{name}")
    with pytest.raises((RuntimeError, AssertionError)):
        mod.main()
