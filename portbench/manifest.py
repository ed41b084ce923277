"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<mix>.json``;
- a cell's limits on what its check compares: ``limits/<cell>.json``;
- an entry, the program's call that a mix drives: ``entries/<entry>.py``;
- a metric's reader: ``end_to_end/<metric>.py`` or ``layers/<metric>.py``.

Adding a cell, a mix, an entry or a metric adds files and entries; no
file that is already there changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: The checkout's root, where ``BENCHMARK.json`` lies.
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One workload of the manifest, with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict | None = None, root: Path = ROOT) -> Cell:
    """The workload ``name`` with its configuration, mix and limits."""
    manifest = load(root / "BENCHMARK.json") if manifest is None else manifest
    here = Path(root) / "portbench"
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=_json(here / "limits" / f"{name}.json"),
                end_to_end=[m for m in manifest["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if _reports(m, name)])


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    """The module of the entry ``name`` (``entries/<name>.py``)."""
    if not (HERE / "entries" / f"{name}.py").is_file():
        raise FileNotFoundError(f"no entry {name!r} in portbench/entries")
    return importlib.import_module(f"portbench.entries.{name}")


def reader(metric: str, per_layer: bool, root: Path = ROOT):
    """The reader module of ``metric``: its ``read(run)`` returns the
    number, or None where the run holds nothing to read."""
    folder = "layers" if per_layer else "end_to_end"
    return _module(Path(root) / "portbench" / folder / f"{metric}.py",
                   "portbench_metric_" + metric.replace(".", "_").replace(
                       "-", "_"))
