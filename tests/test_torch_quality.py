"""The port's quality tool (``go_audio_resampler_tpu_torch/tools/
quality_cuda.py``) against the JAX package's ``tools/quality_tpu.py`` and
its record ``QUALITY_tpu.json``.

The checks' names and limits equal ``QUALITY_tpu.json``'s (its
``pallas_parity_*`` checks are ``kernel_parity_*``: each CUDA kernel
against its plain version).  On the CPU, in float32 on the kernels'
plain versions, the THD, DC-gain and ripple sections pass; DC and
ripple agree with the same metric on the JAX ``oneshot``'s float32
output for the same input (1e-6, 1e-4 dB), the THD sections' outputs
with JAX's within 2e-5 and the THD metric within 0.5 dB in float64 (in
float32 both sit at the rounding floor, see ``test_thd_matches_jax``);
the tier sections meet their
floors (not compared with JAX: JAX on the CPU ignores the reduced tiers
outside its kernels); the soak runs at a shorter length and samples its
input FIFO while feeding.
"""

import importlib
import json
import pathlib
import re
import sys

import numpy as np
import pytest

from go_audio_resampler_tpu.engine import plan_engine as j_plan
from go_audio_resampler_tpu.filterdesign import Quality as JQ
from go_audio_resampler_tpu.utils import metrics as j_metrics
from go_audio_resampler_tpu.utils import signals as j_signals
from go_audio_resampler_tpu_torch.pipeline import buffer
from go_audio_resampler_tpu_torch.tools import quality_cuda as qc

j_oneshot = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_record() -> dict:
    return json.loads((ROOT / "QUALITY_tpu.json").read_text())["checks"]


def _limit(note: str):
    """The number a note of QUALITY_tpu.json states its limit by."""
    m = re.search(r"(?:floor|tol|<=) (-?[0-9.]+(?:e-?[0-9]+)?)", note)
    return float(m.group(1)) if m else None


def _jax_run(plan, x):
    return np.asarray(j_oneshot.oneshot(plan, np.asarray(x, np.float32)[None],
                                        dtype=np.float32))[0] \
        .astype(np.float64)


def _section(fn, **kw):
    rec = qc.Record()
    fn(rec, "cpu", **kw)
    return rec


def test_names_and_limits_equal_quality_tpu():
    want = {name.replace("pallas_parity_", "kernel_parity_"): check
            for name, check in _jax_record().items()}
    assert list(qc.LIMITS) == list(want)
    for name, check in want.items():
        limit = _limit(check.get("note", ""))
        if limit is not None:
            assert qc.LIMITS[name] == limit, name
    assert qc.LIMITS["soak_random_chunks_equal_bulk_maxdiff"] == 0.0
    assert qc.LIMITS["soak_checkpoint_resume_maxdiff"] == 0.0


def test_notes_state_the_limits():
    """Every note the tool writes states the limit it checks."""
    rec = qc.Record()
    for section in (qc.thd_floors, qc.decimation, qc.dc_gain, qc.ripple,
                    qc.tiers):
        section(rec, "cpu")
    for name, check in rec.checks.items():
        assert _limit(check["note"]) == qc.LIMITS[name], name
        assert check["pass"], (name, check)


@pytest.mark.parametrize("q", [JQ.LOW, JQ.HIGH])
def test_thd_matches_jax(q):
    """The section passes its floor in float32, on an output within 2e-5
    of the JAX float32 one-shot's.  The THD values themselves sit at the
    float32 rounding floor (-140 to -150 dB), where float32 outputs that
    agree to a few 1e-7 read more than 0.5 dB apart, so the metric is
    held to 0.5 dB of JAX's on the float64 outputs."""
    import torch
    from go_audio_resampler_tpu_torch import oneshot, plan_engine
    rec = _section(qc.thd_floors)
    name = f"thd_44k_48k_{q.name.lower()}_db"
    assert rec.checks[name]["pass"]
    x = j_signals.sine(qc.N, 1000.0, 44100)
    jplan, tplan = j_plan(44100.0, 48000.0, q), plan_engine(44100.0,
                                                             48000.0, q)
    assert np.abs(qc.run(tplan, x, "cpu") - _jax_run(jplan, x)).max() <= 2e-5
    y64 = oneshot(tplan, x[None], dtype=torch.float64, device="cpu")[0]
    j64 = np.asarray(j_oneshot.oneshot(jplan, x[None], dtype=np.float64))[0]
    assert abs(j_metrics.thd(y64.numpy(), 48000, 1000.0, qc.FFT)
               - j_metrics.thd(j64, 48000, 1000.0, qc.FFT)) <= 0.5


def test_dc_gain_matches_jax():
    rec = _section(qc.dc_gain)
    check = rec.checks["dc_gain_44k_48k_high"]
    want = j_metrics.dc_gain(_jax_run(j_plan(44100.0, 48000.0, JQ.HIGH),
                                      j_signals.dc(16384)))
    assert check["pass"] and abs(check["value"] - want) <= 1e-6


def test_ripple_matches_jax():
    rec = _section(qc.ripple)
    check = rec.checks["passband_ripple_44k_48k_db"]
    plan = j_plan(44100.0, 48000.0, JQ.HIGH)
    amps = []
    for f in (1000.0, 5000.0, 10000.0, 15000.0):
        y = _jax_run(plan, j_signals.sine(qc.N, f, 44100))
        mid = y[len(y) // 4: -len(y) // 4]
        amps.append(np.sqrt(np.mean(mid ** 2)) * np.sqrt(2.0))
    want = 20.0 * np.log10(max(amps) / min(amps))
    assert check["pass"] and abs(check["value"] - want) <= 1e-4


def test_tiers_meet_their_floors(monkeypatch):
    monkeypatch.delenv(qc.TIER_ENV, raising=False)
    rec = _section(qc.tiers)
    assert set(rec.checks) == {"thd_44k_48k_high_fast_tier_db",
                               "thd_44k_48k_high_ingest_tier_db"}
    assert not rec.failures
    import os
    assert qc.TIER_ENV not in os.environ


def test_kernel_parity_skipped_off_the_card(capsys):
    assert not _section(qc.kernel_parity).checks
    assert "skipped off the card" in capsys.readouterr().out


def test_soak_short():
    rec = _section(qc.soak, seconds=1.5)
    assert set(rec.checks) == {n for n in qc.LIMITS if n.startswith("soak")}
    assert not rec.failures
    assert rec.checks["soak_random_chunks_equal_bulk_maxdiff"]["value"] == 0


def test_soak_samples_the_fifo_while_feeding(monkeypatch):
    """The FIFO's fill is read after every chunk while feeding: a fill
    that exceeds its bound only while input is buffered fails the check.
    (After the flush the FIFO is empty whatever it held, so a read there
    would pass.)  The mocked ``available()`` inflates what the tool reads
    while the FIFO holds samples; the engine's own reads are true."""
    real = buffer.SampleFIFO.available
    tool = qc.__name__
    reads = []

    def available(self):
        n = real(self)
        if sys._getframe(1).f_globals.get("__name__") == tool:
            reads.append(n)
            return n + (10 ** 6 if n else 0)
        return n

    monkeypatch.setattr(buffer.SampleFIFO, "available", available)
    rec = _section(qc.soak, seconds=1.5)
    assert rec.failures == ["soak_host_state_bounded"]
    assert any(reads) and len(reads) >= 2
    eng = qc.EngineCore(qc.plan_engine(44100.0, 48000.0, qc.Quality.HIGH),
                        batch=8, block=8192, device="cpu")
    eng.process(np.zeros((8, 10000), np.float32))
    eng.flush()
    assert available(eng._pending) == 0


def test_main_refuses_without_cuda(tmp_path, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "q.json"
    assert qc.main(["--out", str(out)]) == 1
    assert "refusing" in capsys.readouterr().out and not out.exists()


def test_run_checks_records_backend(monkeypatch):
    r = qc.run_checks("cpu", (qc.dc_gain,))
    assert r["backend"] == "cpu" and r["failures"] == []
    assert list(r["checks"]) == ["dc_gain_44k_48k_high"]
