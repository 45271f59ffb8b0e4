"""What every traffic driver shares: the record of a run (``Run``), a
seeded sample of a window's outputs (``Reservoir``), the mix's image bank
as the codec takes it, and a timed half of a closed-loop window through a
pipeline.

A traffic mix is a data file, ``traffic/<mix>.json``, whose ``driver``
names a module of its own, ``drivers/<driver>.py``.  That module's
``run(cell, seconds, seed, run, device)`` builds the system under test
from ``cell.work``, sets it up, measures the window into ``run`` and
returns what the readers and the judge call into (``transform``,
``sigma_of``).  A new kind of traffic is a new driver file; a new mix of a
kind is a new data file.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, List

import numpy as np
import torch

from . import trace
from .bank import image_bank


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length
    (Algorithm R), drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List = []

    def offer(self, make: Callable):
        """Keep the next item (``make()`` builds it only if kept)."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(make())
        else:
            r = int(self.rng.integers(0, i + 1))
            if r < self.k:
                self.items[r] = make()


class Run:
    """What a window produced: the e2e readings, the samples to judge,
    the traced stretches and the lines the run prints."""

    def __init__(self, traced: bool = False, counters=None):
        self.traced, self.counters = traced, counters
        self.metrics: dict = {}
        self.samples: List[dict] = []
        self.stretches: List[trace.Stretch] = []
        self.images: dict = {}      # stretch -> images done
        self.walls: dict = {}       # stretch -> host seconds
        self.attempted = 0
        self.failed = 0
        self.t_first = None
        self.batch = None           # a batch of the bank, for the readers
        self.notes: List[str] = []
        self._t = time.perf_counter()
        self.setup_steps: List[str] = []

    def mark(self, step: str) -> None:
        """Note the host seconds a set-up step took."""
        now = time.perf_counter()
        self.setup_steps.append(f"{step} {now - self._t:.3f} s")
        self._t = now


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bank(codec, mix: dict, seed: int, device):
    """The mix's bank as the codec takes it."""
    return codec.inputs(image_bank(mix["bank"], mix["height"], mix["width"],
                                   seed, mix["alpha"][0], mix["alpha"][1],
                                   device))


def encode_all(codec, batches, depth: int) -> List[List[bytes]]:
    enc = codec.encoder(depth)
    for b in batches:
        enc.submit(b)
    return enc.drain()


def half(name: str, pipe, items, order, seconds: float, on_result,
         device, run: Run) -> int:
    """Submit items[order[k % len]] until ``seconds`` have passed, then
    drain; returns the batches done and records the half's wall time."""
    pending = collections.deque()
    k = 0
    traced = run.traced
    sync(device)
    with trace.traced(name, run):
        t0 = time.perf_counter()
        if run.t_first is None:
            run.t_first = t0
        while time.perf_counter() - t0 < seconds:
            j = order[k % len(order)]
            with trace.span(f"{name}.submit", traced):
                pipe.submit(items[j])
            pending.append(j)
            k += 1
            if k > pipe.depth:
                with trace.span(f"{name}.collect", traced):
                    res = pipe.collect()
                on_result(pending.popleft(), res)
        with trace.span(f"{name}.drain", traced):
            rest = pipe.drain()
        for res in rest:
            on_result(pending.popleft(), res)
        sync(device)
        run.walls[name] = time.perf_counter() - t0
    return k
