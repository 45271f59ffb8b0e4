"""One run of one cell: ``run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``.

Everything of a cell is found by name from ``BENCHMARK.json``: the cell's
configuration file (``configs/<config>.json``), whose ``work`` and
``reference`` name the modules ``work/<name>.py`` (the system under test
and its operation counts) and ``reference/<name>.py`` (the plain
reference); the traffic mix ``traffic/<mix>.json``, run by the driver
module that it names, ``drivers/<driver>.py`` (``sicbench/drive.py`` says
what a driver does); and each per-layer metric's reader
``metrics/<metric>.py``.

The mix's driver builds the system under test, makes its inputs from the
seed, warms it and measures the window; the harness then reads the peak
memory, checks that no JAX module was loaded, and judges a seeded sample
of the window's outputs against the plain reference.  It prints each number compared beside its limit on standard
error, then one JSON line on standard output.  With ``--trace 1`` the
metrics are the cell's per-layer metrics, read from the traced window.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Dict, Optional

import torch

from . import drive, trace, timing

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "simple_image_compression_network_tpu")
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)


class Refused(Exception):
    """A run that must end without a result line."""


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise Refused(f"{os.path.relpath(path, ROOT)} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, spec_path: Optional[str] = None):
        with open(spec_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
            spec = json.load(f)
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.w = name, cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.w["config"]]
        with open(os.path.join(ROOT, conf["file"])) as f:
            self.cfg = json.load(f)
        with open(os.path.join(HERE, "traffic",
                               self.w["traffic"] + ".json")) as f:
            self.mix = json.load(f)
        self.e2e = [m for m in spec["end_to_end"]
                    if name in m.get("workloads", [name])]
        names = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in names)]
        self.chips = self.w["chips"]
        self.root = ROOT
        self.driver = load(os.path.join(HERE, "drivers",
                                        self.mix["driver"] + ".py"),
                           "driver_" + self.mix["driver"])
        self.work = load(os.path.join(HERE, "work", self.cfg["work"] + ".py"),
                         "work_" + self.cfg["work"])

    def reference(self, device):
        mod = load(os.path.join(HERE, "reference",
                                self.cfg["reference"] + ".py"),
                   "reference_" + self.cfg["reference"])
        return mod.Reference(self.cfg, ROOT, device)

    def reader(self, metric: str):
        return load(os.path.join(HERE, "metrics", metric + ".py"),
                    "metric_" + metric.replace(".", "_"))


def port_counters() -> Dict[str, int]:
    """The program's launch counters, by the names ``trace.PORT_KERNELS``
    uses."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    from simple_image_compression_network_tpu_torch.ops import cuda_conv
    out = {}
    for names in trace.PORT_KERNELS.values():
        for n in names:
            fn = getattr(cuda_conv, n, None) or getattr(cuda_rans, n)
            out[n] = fn.launches
    return out


class Readers:
    """What a per-layer reader reads: the traced stretches of the window,
    the images each did, the configuration's work and peak, and the
    transform's time alone, taken once asked for."""

    def __init__(self, cell: Cell, run: drive.Run, codec):
        self.cell, self.run, self.codec = cell, run, codec
        self.stretch = {s.name: s for s in run.stretches}
        self.h, self.w = cell.mix["height"], cell.mix["width"]
        self._ms: Dict[str, float] = {}

    def kernels_per_image(self, name: str):
        s = self.stretch.get(name)
        if s is None or not self.run.images.get(name):
            return None
        return len(s.device) / self.run.images[name]

    def idle_pct(self, name: str):
        s = self.stretch.get(name)
        return None if s is None else s.idle_pct()

    def mfu(self, name: str):
        """The model's operations for the images the stretch did, over
        its host time at the stated precision's peak, in %."""
        if name not in self.stretch or not self.run.images.get(name):
            return None
        ops = self.cell.work.ops(name, self.h, self.w) * self.run.images[name]
        return 100.0 * ops / (self.run.walls[name]
                              * self.cell.cfg["peak_ops_per_s"]
                              * self.cell.chips)

    def transform_roofline(self, direction: str):
        """The least time of the direction's transform on a batch (its
        operations at the peak or its bytes at 3.35 TB/s, the larger),
        over its time alone, in %."""
        if direction not in self.stretch or self.run.batch is None:
            return None
        if direction not in self._ms:
            self._ms[direction], how = timing.kernel_ms(
                self.codec.transform(direction, self.run.batch))
            log(f"transform {direction} timed {how}")
        b = self.run.batch.shape[0]
        bound_s = max(
            self.cell.work.ops(direction, self.h, self.w) * b
            / self.cell.cfg["peak_ops_per_s"],
            self.cell.work.bytes_moved(direction, self.h, self.w) * b
            / PEAK_BYTES_S)
        log(f"transform {direction} at B = {b}: {self._ms[direction]} ms "
            f"alone, bound {bound_s * 1e3} ms")
        return 100.0 * bound_s * 1e3 / self._ms[direction]


def check_profile(stretch: trace.Stretch) -> None:
    """The profile must hold every launch of the program's own kernels in
    the stretch, and at least one."""
    total = 0
    for sub, names in trace.PORT_KERNELS.items():
        want = sum(stretch.launched[n] for n in names)
        seen = stretch.count(sub)
        total += want
        if seen != want:
            raise Refused(
                f"the {stretch.name} profile holds {seen} records of "
                f"{sub}, the program's counters {want} launches: the "
                f"profiler does not see the program's kernels, so no idle "
                f"share or kernel count is read from it")
    if total == 0:
        raise Refused(f"the {stretch.name} stretch launched none of the "
                      f"program's kernels")


def merge(acc: Dict[str, float], part: Dict[str, float]) -> None:
    """Counts add up; gaps (floats) keep their largest."""
    for k, v in part.items():
        if isinstance(v, float):
            acc[k] = max(acc.get(k, 0.0), v)
        else:
            acc[k] = acc.get(k, 0) + v


def judge(cell: Cell, run: drive.Run, codec, device) -> Dict[str, dict]:
    ref = cell.reference(device)
    got: Dict[str, float] = {}
    for s in run.samples:
        merge(got, ref.judge(s["blobs"], codec.sigma_of, x=s.get("x"),
                             x_hat=s.get("x_hat"), y_hat=s.get("y_hat")))
    limits = cell.cfg["limits"]
    got["outputs_judged"] = sum(len(s["blobs"]) for s in run.samples)
    checks = {k: {"value": got.get(k), "limit": limits[k]} for k in limits}
    checks["outputs_judged"] = {"value": got["outputs_judged"],
                                "min": 1}
    return checks


def passed(checks: Dict[str, dict]) -> bool:
    ok = checks["outputs_judged"]["value"] >= 1
    for k, c in checks.items():
        if "limit" in c:
            ok = ok and c["value"] is not None and c["value"] <= c["limit"]
    return ok


def jax_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float):
    """Set-up and the window -> (codec, run, setup_s)."""
    run = drive.Run(traced, port_counters)
    run.setup_steps.append(f"imports {run._t - t_start:.3f} s")
    codec = cell.driver.run(cell, seconds, seed, run, device)
    for s in run.stretches:
        check_profile(s)
    return codec, run, run.t_first - t_start


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark measures the card "
                          "and never runs on the host")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} present")
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", t_start)
    except Refused as e:
        log(f"refused: {e}")
        return 2
    print(json.dumps(line), flush=True)
    return 0


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """The whole run on ``device`` -> the result line.  (``main`` looks
    for the card first; the tests drive this on the host.)"""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    codec, run, setup_s = measure(cell, seed, seconds, traced, device,
                                  t_start)
    dev = device_info(cell.chips) if cuda else {
        "platform": "cpu", "kind": "host", "count": 0,
        "memory_peak_bytes": 0}
    log("set-up: " + "; ".join(run.setup_steps))
    for note in run.notes:
        log(note)
    if traced:
        readers = Readers(cell, run, codec)
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(readers)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = sum(s.busy_s for s in run.stretches)
        dev["window_s"] = sum(s.window_s for s in run.stretches)
        ops, gaps = {}, {}
        for s in run.stretches:
            for k, v in s.device_ops().items():
                ops[k] = ops.get(k, 0.0) + v
            gaps.update({f"{s.name}: {k}": v
                         for k, v in s.idle_gaps().items()})
        breakdown = {"device_ops": trace.top(ops),
                     "idle_gaps": trace.top(gaps)}
    else:
        run.metrics["setup_s"] = setup_s
        metrics = {m["name"]: {"value": run.metrics[m["name"]],
                               "unit": m["unit"]} for m in cell.e2e}
    checks = judge(cell, run, codec, device)
    found = jax_loaded()
    if found:
        raise Refused(f"modules of JAX or the JAX package were loaded: "
                      f"{found}")
    ok = passed(checks)
    log(f"setup_s {setup_s}; device {dev}")
    for k, c in checks.items():
        bound = c.get("limit", c.get("min"))
        rel = "<=" if "limit" in c else ">="
        log(f"check {k}: {c['value']} {rel} {bound}")
    line = {"correct": ok, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev}
    if traced:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line
