"""Reading ``torch.profiler``'s record of a traced stretch.

A traffic driver wraps each traced stretch (a half of a bulk window) in a
profiler session and marks it, and each call it makes into the program
inside it, by ``record_function`` ranges named ``bench.*``.  From
the raw kineto events this module gives the device's busy intervals inside
the stretch, its idle share, the device records by name, the idle gaps by
the harness call the host was in, and the count of the program's own
kernels, which the harness holds against the program's launch counters.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# substrings of the program's hand-written kernels -> the launch counters
# (of ``ops/cuda_conv.py`` and ``codec/cuda_rans.py``) that count them
PORT_KERNELS = {
    "conv_taps_mma_kernel": ("conv3x3_s1_int8", "conv_sparse_int8"),
    "rans_encode_kernel": ("encode_batch_compact",
                           "encode_batch_compact_ctx"),
    "rans_decode_kernel": ("decode", "decode_ctx"),
    "rans_encode_dense_kernel": ("encode_dense",),
}


class Stretch:
    """One traced stretch, after its session has closed."""

    def __init__(self, name: str, prof: profile):
        self.name = name
        events = prof.profiler.kineto_results.events()
        self.device: List[Tuple[int, int, str]] = []
        self.spans: List[Tuple[int, int, str]] = []
        mark = f"bench.{name}"
        window = None
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the harness's ranges also show on the device's timeline
                # (user annotations): they are no device work
                if not e.name().startswith("bench."):
                    self.device.append((start, end, e.name()))
            elif e.name() == mark:
                window = (start, end)
            elif e.name().startswith("bench."):
                self.spans.append((start, end, e.name()[len("bench."):]))
        if window is None:
            raise RuntimeError(f"the trace holds no {mark} range")
        # the session holds the stretch's device work alone (it opens and
        # closes on an idle device), so every device record counts; the
        # host's range sets the window's length
        self.t0, self.t1 = window
        self.device.sort()
        self.spans.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of device activity."""
        out: List[Tuple[int, int]] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def count(self, substring: str) -> int:
        return sum(1 for _, _, n in self.device if substring in n)

    def device_ops(self) -> Dict[str, float]:
        """Seconds of device activity by record name."""
        out: Dict[str, float] = collections.defaultdict(float)
        for s, e, n in self.device:
            out[n] += (e - s) * 1e-9
        return out

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds of idle device by the harness call that the host was
        in when each gap began ("between calls" outside them)."""
        out: Dict[str, float] = collections.defaultdict(float)
        busy = self.busy()
        edges = ([min(self.t0, busy[0][0])] + [x for b in busy for x in b]
                 + [max(self.t1, busy[-1][1])])
        spans = self.spans
        j = 0
        for k in range(0, len(edges), 2):
            g0, g1 = edges[k], edges[k + 1]
            if g1 <= g0:
                continue
            while j < len(spans) and spans[j][1] < g0:
                j += 1
            name = "between calls"
            for s, e, n in spans[j:j + 4]:
                if s <= g0 < e:
                    name = n
                    break
            out[name] += (g1 - g0) * 1e-9
        return out


@contextlib.contextmanager
def traced(name: str, run):
    """Profile the block when ``run.traced`` and mark it ``bench.<name>``;
    the ``Stretch`` read from it, with the program's launches counted by
    ``run.counters()`` across it (``launched``), goes to
    ``run.stretches``."""
    if not run.traced:
        yield
        return
    before = run.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(f"bench.{name}"):
            yield
    after = run.counters()
    stretch = Stretch(name, prof)
    stretch.launched = {k: after[k] - before[k] for k in after}
    run.stretches.append(stretch)


def span(name: str, on: bool):
    """A ``bench.<name>`` range around one call into the program."""
    return record_function(f"bench.{name}") if on else contextlib.nullcontext()


def top(d: Dict[str, float], n: int = 10, width: int = 160) -> List[list]:
    """The n largest entries, names cut to ``width`` characters (a kernel's
    demangled name runs to some hundreds)."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
