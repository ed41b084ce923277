"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files, as a cell added as new files alone is."""

import json
import re
import shutil

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert M["command"] == ["python3", "portbench/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_are_unique_and_well_formed(key):
    names = [e["name"] for e in M[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else 1
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # A per-layer metric's cells report the metric it moves.
        mover = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mover.get("workloads", CELLS))


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = manifest.cell(name)
    assert cell.chips == 1
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        assert callable(manifest.reader(m["name"], False).read)
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"], True).read)
    assert hasattr(manifest.entry(cell.traffic["entry"]), "Driver")
    assert set(cell.limits) == {"max_rel_err", next(
        k for k in cell.limits if k != "max_rel_err")}


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("portbench/configs/")
    data = json.loads((manifest.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in M["workloads"])


def test_a_cell_added_as_new_files_alone_resolves(tmp_path):
    """A new mix, its limits and a per-layer reader, added as files, with
    entries appended to the manifest: no file that was there changes."""
    shutil.copytree(manifest.HERE, tmp_path / "portbench")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(M))
    bench["workloads"].append({"name": "opus48.small", "config": "opus48-hq",
                               "traffic": "small", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "device.idle_share.small", "unit": "share",
        "better": "lower", "source": "device_trace", "layer": "Device",
        "moves": "in_msamples_per_s", "workloads": ["opus48.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    (pb / "traffic" / "small.json").write_text(json.dumps(
        {**json.loads((pb / "traffic" / "serve.json").read_text()),
         "streams": 64}))
    (pb / "limits" / "opus48.small.json").write_text(
        (pb / "limits" / "opus48.serve.json").read_text())
    shutil.copy(pb / "layers" / "device.idle_share.serve.py",
                pb / "layers" / "device.idle_share.small.py")
    cell = manifest.cell("opus48.small", root=tmp_path)
    assert cell.traffic["streams"] == 64
    assert [m["name"] for m in cell.per_layer] == ["device.idle_share.small"]
    assert manifest.reader("device.idle_share.small", True, root=tmp_path)
    for p, data in before.items():
        assert p.read_bytes() == data
