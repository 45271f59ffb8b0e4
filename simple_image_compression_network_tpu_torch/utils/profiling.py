"""The port's tracing: spans of the host glue, on the clock of
``torch.profiler``'s trace, and ``trace``, the operator's profiler entry.

``span(name, **sizes)`` records a span: its name, start and end, the span
it opened inside (``parent``) and optional sizes (``pinned_bytes`` ...).

* Spans are recorded only while a ``torch.profiler`` session records
  (``torch._C._autograd._profiler_enabled``).  Otherwise ``span`` returns
  one shared no-op context and records and allocates nothing.
* Start and end are Unix-epoch ns (``time.time_ns``), the clock on which
  kineto stamps host ranges and against which it places the card's
  records, so each idle gap of the device can be put down to the innermost
  span the host was in.
* They are never ``record_function`` ranges: kineto mirrors those onto the
  device timeline as user annotations, which a reader of the device's busy
  time would count as device work.
* Each thread nests its own spans.  ``RECORDER`` keeps them until
  ``RECORDER.take()``; ``trace`` takes those of its block, and a caller
  that runs its own profiler session takes them when it ends.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, List

import torch
from torch.profiler import ProfilerActivity, profile

_recording = torch._C._autograd._profiler_enabled


class _Off:
    """The span returned while nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "sizes", "_stack")

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        top = self._stack.pop()
        assert top is self, "spans closed out of order"
        return False


class Recorder:
    """The spans recorded since the last ``take``, in the order they
    opened."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._local = threading.local()     # .stack: this thread's open spans

    def open(self, name: str, sizes: dict) -> Span:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        sp = Span()
        sp.name, sp.end_ns, sp.sizes, sp._stack = name, None, sizes, stack
        sp.parent = stack[-1] if stack else None
        stack.append(sp)
        self.spans.append(sp)
        sp.start_ns = time.time_ns()
        return sp

    def take(self) -> List[Span]:
        """The spans recorded so far, which the recorder then forgets."""
        spans, self.spans = self.spans, []
        return spans

    @staticmethod
    def export(path: str, spans: List[Span]) -> None:
        """Write ``spans`` as JSON, each parent as an index into the list
        (None for a root, or a parent outside the list)."""
        index = {id(s): i for i, s in enumerate(spans)}
        with open(path, "w") as f:
            json.dump({"clock": "unix_ns", "spans": [
                dict(name=s.name, start_ns=s.start_ns, end_ns=s.end_ns,
                     parent=index.get(id(s.parent)), **s.sizes)
                for s in spans]}, f)


RECORDER = Recorder()


def span(name: str, **sizes):
    """A span of the host glue, recorded while a profiler session records
    (see the module's docstring); use it as a context manager."""
    if not _recording():
        return _OFF
    return RECORDER.open(name, sizes)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the enclosed block (the CPU, and the card where there is
    one) and write ``<log_dir>/trace.json``, a Chrome trace, and
    ``<log_dir>/spans.json``: the program's spans of the block in
    Unix-epoch ns, where an event of ``trace.json`` lies at ``ts`` x 1000
    + ``baseTimeNanoseconds``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    RECORDER.take()                     # spans no one took before the block
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    RECORDER.export(os.path.join(log_dir, "spans.json"), RECORDER.take())
