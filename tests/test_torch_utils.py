"""The port's utilities: tensor dumps, the profiler trace with the
program's spans, the checks, and where the compile cache puts the
builds."""

import json
import os

import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu_torch import _build
from simple_image_compression_network_tpu_torch.codec import rans
from simple_image_compression_network_tpu_torch.utils import (
    cache, checks, dump, native_golden, profiling)

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_dump_round_trips(tmp_path):
    x = torch.arange(6, dtype=torch.int8).reshape(2, 3)
    assert dump.dump("act", x) is x            # disabled: identity, no file
    dump.enable(str(tmp_path))
    try:
        assert dump.dump("act", x * 2) is not None
        dump.dump("act", x)
        dump.dump("other", x.float())
    finally:
        dump.disable()
    assert sorted(os.listdir(tmp_path)) == ["act_0.npy", "act_1.npy",
                                            "other_0.npy"]
    np.testing.assert_array_equal(dump.load(str(tmp_path), "act", 0),
                                  (x * 2).numpy())
    np.testing.assert_array_equal(dump.load(str(tmp_path), "act", 1),
                                  x.numpy())
    assert dump.load(str(tmp_path), "other").dtype == np.float32


def test_trace_writes_a_chrome_trace(tmp_path):
    with torch.profiler.profile():          # a session no one takes from
        with profiling.span("left over"):
            pass
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("my_stage"):
            with profiling.span("my_step", pinned_bytes=64):
                torch.ones((16, 16)) @ torch.ones((16, 16))
    with open(tmp_path / "tr" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::matmul" in names and not {"my_stage", "my_step"} & names
    with open(tmp_path / "tr" / "spans.json") as f:
        spans = json.load(f)
    assert spans["clock"] == "unix_ns"
    outer, inner = spans["spans"]
    assert (outer["name"], outer["parent"]) == ("my_stage", None)
    assert (inner["name"], inner["parent"], inner["pinned_bytes"]) == (
        "my_step", 0, 64)
    assert (outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"]
            <= outer["end_ns"])
    assert profiling.RECORDER.spans == []   # trace took what it wrote


def test_checks():
    checks.assert_divisible(48, 16)
    with pytest.raises(ValueError):
        checks.assert_divisible(50, 16, "x")
    fm = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
    checks.assert_feature_map(fm, 3)
    checks.assert_feature_map(fm.numpy())
    for bad, ch in ((fm, 4), (fm[0], None)):
        with pytest.raises(AssertionError):
            checks.assert_feature_map(bad, ch)
    checks.assert_int8_wire(fm)
    checks.assert_int8_wire(np.zeros(2, np.int8))
    with pytest.raises(AssertionError):
        checks.assert_int8_wire(fm.to(torch.int32))


def test_assert_deterministic_catches_a_difference():
    x = torch.arange(5.0)
    checks.assert_deterministic(lambda v: (v * 2, {"n": torch.tensor(
        float("nan"))}), x, runs=3)
    calls = []

    def drifting(v):
        calls.append(1)
        return [v, v + (len(calls) > 1) * 1e-7]
    with pytest.raises(AssertionError, match="run 1"):
        checks.assert_deterministic(drifting, x)
    outs = iter([torch.zeros(2, dtype=torch.int32), torch.zeros(2)])
    with pytest.raises(AssertionError):     # the same bytes, another dtype
        checks.assert_deterministic(lambda: next(outs))


def test_enable_compile_cache_moves_the_build_roots(tmp_path, monkeypatch):
    for mod in (_build, rans, native_golden):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_BUILD_ROOT", mod._BUILD_ROOT)
    default = (_build._BUILD_ROOT, rans._BUILD_ROOT,
               native_golden._BUILD_ROOT)
    assert default == (os.path.join(ROOT, "build", "torch_kernels"),
                       os.path.join(ROOT, "build", "torch_host"),
                       os.path.join(ROOT, "build", "torch_host"))
    cache.enable_compile_cache(str(tmp_path / "cc"))
    assert _build._BUILD_ROOT == str(tmp_path / "cc" / "torch_kernels")
    assert rans._BUILD_ROOT == str(tmp_path / "cc" / "torch_host")
    assert native_golden._BUILD_ROOT == str(tmp_path / "cc" / "torch_host")
    cache.enable_compile_cache()
    assert (_build._BUILD_ROOT, rans._BUILD_ROOT,
            native_golden._BUILD_ROOT) == default


def test_enable_compile_cache_refuses_after_load(tmp_path, monkeypatch):
    for mod in (_build, rans, native_golden):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_BUILD_ROOT", mod._BUILD_ROOT)
    monkeypatch.setattr(rans, "_lib", object())
    with pytest.raises(RuntimeError, match="rANS"):
        cache.enable_compile_cache(str(tmp_path))
    assert rans._BUILD_ROOT == os.path.join(ROOT, "build", "torch_host")
