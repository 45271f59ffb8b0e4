"""Tracing and profiling utilities.

The PyTorch counterpart of the JAX package's ``utils/profiling.py``.  The
reference's observability is ``#ifdef DEBUG`` stream-size prints and HLS
cycle reports; here:

* ``StageTimer``: wall-clock per named stage, the current CUDA device
  synchronized at both ends (nothing to wait for on the CPU), reported as
  the reference printed per-layer banners (conv_nonsquare_top.cpp:302-355);
* ``trace``: a ``torch.profiler`` context that writes a Chrome trace of the
  enclosed block into a directory;
* ``annotate``: a named range (``torch.profiler.record_function``) that
  shows in the trace;
* ``throughput_mps`` / ``throughput_tmacs``: MP/s and TMAC/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates wall-clock per named stage (device-synced)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:30s} {total*1e3:10.2f} ms total "
                         f"({n}x, {total/n*1e3:.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the enclosed block (the CPU, and the card where there is
    one) and write ``<log_dir>/trace.json``, a Chrome trace."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range visible in the trace."""
    return record_function(name)


def throughput_mps(pixels: int, seconds: float) -> float:
    return pixels / seconds / 1e6


def throughput_tmacs(macs: int, seconds: float) -> float:
    return macs / seconds / 1e12
