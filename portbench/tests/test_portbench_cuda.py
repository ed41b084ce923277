"""On the card: each cell's command, briefly (6 s: longer than the
longest trace, so that the host-clock metrics read before it have
requests), comes out correct with its metrics; and in a directory that
holds only BENCHMARK.json and the benchmark's folder it exits with
another code than 0 and prints no result.  Run with
``python -m pytest -m cuda portbench/tests``."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import manifest

ROOT = Path(__file__).resolve().parents[2]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(cwd, cell, trace):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**35 + 11), "--seconds", "6", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=cwd)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"]
                                  for w in manifest.load()["workloads"]])
def test_cell_runs_correct(cell, trace):
    _card()
    out = _run(ROOT, cell, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    c = manifest.cell(cell)
    want = c.per_layer if trace else c.end_to_end
    assert r["correct"] and set(r["metrics"]) == {m["name"] for m in want}
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


@pytest.mark.cuda
def test_benchmark_alone_is_no_run(tmp_path):
    _card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    out = _run(tmp_path, "opus48.serve", 0)
    assert out.returncode != 0 and "{" not in out.stdout
