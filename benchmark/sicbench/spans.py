"""The program's own spans (``utils/profiling.py`` of the port) against a
traced stretch: the device's idle time by the innermost program span the
host was in, and the host glue's busy and waiting time (logged).

The program records spans only while a profiler session records, so only
inside the traced halves, and stamps them on the clock of the profiler's
host ranges (Unix-epoch ns), against which the harness already holds the
card's records.  Each span goes to the half whose window lies nearest; one
that lies outside every window by more than ``SLACK_NS`` means the clocks
disagree, and the readers give nothing.  Where the program records no
spans (it has no recorder, or none recorded) they give nothing too.

A span's self time is its length less what the spans inside it cover:
at each instant the host glue is in its innermost open span.  ``wait``
spans are the host blocked on the card; every other span is host work.
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, List, Optional, Tuple

from .harness import log

SLACK_NS = 1_000_000
WAIT = "wait"


@functools.lru_cache(maxsize=8)
def program_spans(ctx) -> Optional[list]:
    """The program's closed spans (start_ns, end_ns, name, sizes), taken
    from its recorder once for the run ``ctx``, or None where the program
    has no recorder."""
    try:
        from simple_image_compression_network_tpu_torch.utils import (
            profiling)
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    if rec is None:
        return None
    return [(s.start_ns, s.end_ns, s.name, s.sizes)
            for s in rec.take() if s.end_ns is not None]


def innermost(spans) -> List[Tuple[int, int, str]]:
    """Nested spans (start, end, name, ...) -> disjoint segments (start,
    end, name of the innermost span open there), in time order."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []       # (end, name), innermost last
    now = None
    for s in sorted(spans, key=lambda s: (s[0], -s[1])):
        t0, t1, name = s[0], s[1], s[2]
        while stack and stack[-1][0] <= t0:
            end, n = stack.pop()
            out.append((now, end, n))
            now = end
        if stack:
            out.append((now, t0, stack[-1][1]))
            t1 = min(t1, stack[-1][0])
        stack.append((t1, name))
        now = t0
    while stack:
        end, n = stack.pop()
        out.append((now, end, n))
        now = end
    return [seg for seg in out if seg[1] > seg[0]]


def idle(t0: int, t1: int, busy) -> List[Tuple[int, int]]:
    """[t0, t1] less the sorted, disjoint busy intervals."""
    out, now = [], t0
    for s, e in busy:
        if s > now:
            out.append((now, min(s, t1)))
        now = max(now, e)
        if now >= t1:
            break
    if now < t1:
        out.append((now, t1))
    return [(s, e) for s, e in out if e > s]


def overlap(segs, gaps) -> Dict[str, int]:
    """ns of the sorted, disjoint ``gaps`` inside each name's segments."""
    out: Dict[str, int] = collections.defaultdict(int)
    j = 0
    for s, e, name in segs:
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            out[name] += min(e, gaps[k][1]) - max(s, gaps[k][0])
            k += 1
    return out


def of_half(spans, windows: Dict[str, Tuple[int, int]], half: str):
    """The spans nearest ``half``'s window, or (None, why) where one lies
    outside every window by more than ``SLACK_NS``."""
    mine = []
    for sp in spans:
        off = {n: max(w0 - sp[0], sp[1] - w1, 0)
               for n, (w0, w1) in windows.items()}
        near = min(off, key=off.get)
        if off[near] > SLACK_NS:
            return None, (f"the program's span {sp[2]!r} lies "
                          f"{off[near] * 1e-6:.3f} ms outside every traced "
                          f"window: its clock is not the profiler's")
        if near == half:
            mine.append(sp)
    return mine, None


@functools.lru_cache(maxsize=8)
def analyse(ctx, half: str) -> Optional[dict]:
    """The half's shares and idle split, or None (logged why)."""
    stretch = ctx.stretch.get(half)
    if stretch is None:
        return None
    spans = program_spans(ctx)
    if not spans:
        log(f"{half}: the program recorded no spans")
        return None
    windows = {n: (s.t0, s.t1) for n, s in ctx.stretch.items()}
    mine, why = of_half(spans, windows, half)
    if mine is None:
        log(f"{half}: {why}")
        return None
    t0, t1 = stretch.t0, stretch.t1
    segs = [(max(s, t0), min(e, t1), n) for s, e, n in innermost(mine)
            if e > t0 and s < t1]
    host: Dict[str, int] = collections.defaultdict(int)
    for s, e, n in segs:
        host[n] += e - s
    gaps = idle(t0, t1, stretch.busy())
    split = overlap(segs, gaps)
    idle_ns = sum(e - s for s, e in gaps)
    pins = [sp[3] for sp in mine if sp[2] == "pin"]
    return {
        "window_ns": t1 - t0,
        "host_busy_ns": sum(v for n, v in host.items() if n != WAIT),
        "host_wait_ns": host.get(WAIT, 0),
        "idle_ns": idle_ns,
        "idle_in_host_ns": sum(v for n, v in split.items() if n != WAIT),
        "idle_by_span": dict(split,
                             outside=idle_ns - sum(split.values())),
        "batches": sum(1 for sp in mine if sp[2] == "pipeline.schedule"),
        "pinned_allocs": len(pins),
        "pinned_bytes": sum(p["pinned_bytes"] for p in pins),
        "refetches": sum(sp[3].get("refetches", 0) for sp in mine),
        "escape_syncs": sum(sp[3].get("escape_syncs", 0) for sp in mine),
        "spans": len(mine),
    }


def pct(ctx, half: str, key: str) -> Optional[float]:
    """``key`` (ns) of the half's analysis over its window, in %."""
    a = analyse(ctx, half)
    return None if a is None else 100.0 * a[key] / a["window_ns"]


@functools.lru_cache(maxsize=8)
def describe(ctx) -> None:
    """Log, once for each traced half, its idle split by innermost program
    span, and its pinned allocations and re-fetches a batch (every half,
    also one whose own metrics the cell does not report)."""
    for half in ctx.stretch:
        a = analyse(ctx, half)
        if a is None:
            continue
        split = ", ".join(f"{n} {v * 1e-9:.4f} s" for n, v in sorted(
            a["idle_by_span"].items(), key=lambda kv: -kv[1]))
        b = max(a["batches"], 1)
        log(f"{half}: device idle {a['idle_ns'] * 1e-9:.4f} s of "
            f"{a['window_ns'] * 1e-9:.4f} s, by innermost program span: "
            f"{split}")
        log(f"{half}: {a['batches']} batches, {a['spans']} spans "
            f"({a['spans'] / b:.2f} a batch); host busy "
            f"{a['host_busy_ns'] * 1e-9:.4f} s, waiting "
            f"{a['host_wait_ns'] * 1e-9:.4f} s; pinned allocations "
            f"{a['pinned_allocs'] / b:.2f} a batch, "
            f"{a['pinned_bytes'] / b:.0f} bytes a batch; re-fetches "
            f"{a['refetches']}, escape syncs {a['escape_syncs']}")
