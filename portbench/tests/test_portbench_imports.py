"""No run loads JAX or the JAX package, compared by whole top-level names
(the port's name begins with the JAX package's); the reference imports
nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as runner
from portbench.tests.small import SMALL

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    assert not _imports(path) & set(runner.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py"))
                         + [HERE / "costs.py"],
                         ids=lambda p: p.name)
def test_reference_and_costs_import_nothing_of_the_program(path):
    assert not _imports(path) & {"go_audio_resampler_tpu_torch", "portbench"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "go_audio_resampler_tpu_torchx", None)
    monkeypatch.delitem(sys.modules, "go_audio_resampler_tpu", raising=False)
    assert "go_audio_resampler_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    assert runner.forbidden_modules() == ["jax"]


def test_a_run_loads_neither(tmp_path):
    """A whole small run in a fresh process: nothing it loads is JAX or
    the JAX package."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness, run
r = harness.run_cell("opus48.serve", 5, 0.2, False, device="cpu",
                     overrides={json.dumps(SMALL["opus48.serve"])!r} and
                     json.loads({json.dumps(json.dumps(SMALL["opus48.serve"]))}),
                     log=lambda s: None)
print(json.dumps([r["correct"], run.forbidden_modules(),
                  "go_audio_resampler_tpu_torch" in sys.modules]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], True]


def test_no_card_no_result(tmp_path):
    """Without a card the command exits with another code than 0 and
    prints no result."""
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "opus48.serve", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and "{" not in out.stdout
