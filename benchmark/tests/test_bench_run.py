"""A run's last line, its import check, and a run without a card."""

import ast
import glob
import json
import os
import subprocess
import sys
import time

import pytest

from conftest import BENCH, ROOT, small
from sicbench import harness


@pytest.fixture(scope="module")
def int8_line():
    cell = small(harness.Cell("int8_ref.bulk_b32"), height=64, width=48)
    return harness.run_cell(cell, 2**31 + 5, 0.6, False, "cpu",
                            time.perf_counter())


def test_last_line_schema(int8_line):
    line = json.loads(json.dumps(int8_line))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"setup_s", "encode_mp_s", "bpp"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    for name, c in line["checks"].items():
        assert "value" in c and ("limit" in c or "min" in c), name


def test_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.jax_loaded() == []       # the port's own name passes
    assert "simple_image_compression_network_tpu_torch" in sys.modules
    monkeypatch.setitem(sys.modules,
                        "simple_image_compression_network_tpu.codec", sys)
    assert harness.jax_loaded() == ["simple_image_compression_network_tpu"]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.jax_loaded()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        names = set(_imports(path))
        assert names <= {"__future__", "math", "os", "struct", "typing",
                         "numpy", "torch", "rans_plain"}, (path, names)


def test_harness_imports_no_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        names = set(_imports(path))
        assert not names & set(harness.FORBIDDEN), path


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "int8_ref.bulk_b32", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_only_the_benchmark_fails_without_the_program(tmp_path):
    """In a directory that holds BENCHMARK.json and benchmark/ alone the
    run ends non-zero, without a result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hyper_scale.bulk_b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""

