"""BENCHMARK.json against the contract's shape, and every piece of each
cell found by name."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT
from sicbench import harness

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    cells = len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, cells // 4)
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_pieces(name):
    cell = harness.Cell(name)
    assert callable(cell.driver.run)
    assert {m["name"] for m in cell.e2e} >= {"setup_s"}
    assert len(cell.e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in cell.e2e}
    assert hasattr(cell.work, "Codec") and callable(cell.work.ops)
    path = os.path.join(BENCH, "reference", cell.cfg["reference"] + ".py")
    assert os.path.exists(path)
    for key in ("source", "reduced", "assumed", "precision",
                "peak_ops_per_s", "limits", "weights"):
        assert key in cell.cfg


def test_missing_piece_is_refused(tmp_path):
    spec = dict(SPEC, workloads=[dict(SPEC["workloads"][0],
                                      traffic="no_such_mix")])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(FileNotFoundError):
        harness.Cell(SPEC["workloads"][0]["name"], str(path))
    with pytest.raises(harness.Refused):
        harness.Cell("no.such_cell")


def test_a_new_driver_is_found_by_name(tmp_path, monkeypatch):
    """A new kind of traffic is a driver file and a mix naming it: no
    file of the harness changes."""
    import shutil
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "drivers" / "echo.py").write_text(
        "def run(cell, seconds, seed, rec, device):\n"
        "    return 'echo'\n")
    mix = json.load(open(bench / "traffic" / "bulk_b8.json"))
    (bench / "traffic" / "echo_b8.json").write_text(
        json.dumps(dict(mix, driver="echo")))
    spec = dict(SPEC, workloads=[dict(SPEC["workloads"][-1],
                                      name="hyper_scale.echo_b8",
                                      traffic="echo_b8")])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "HERE", str(bench))
    cell = harness.Cell("hyper_scale.echo_b8", str(path))
    assert cell.driver.run(cell, 1.0, 1, None, "cpu") == "echo"
    (bench / "traffic" / "echo_b8.json").write_text(
        json.dumps(dict(mix, driver="no_such_driver")))
    with pytest.raises(harness.Refused):
        harness.Cell("hyper_scale.echo_b8", str(path))
