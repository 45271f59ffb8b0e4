"""The part of the traced decode half's device idle time that falls inside a
program span other than ``wait`` (utils/profiling.py), over the half's
window: the idle that the program's host steps leave.  Logs the idle split
by innermost program span of every traced half, the pinned allocations
and the re-fetches (sicbench/spans.py)."""

from sicbench import spans


def read(ctx):
    spans.describe(ctx)
    return spans.pct(ctx, "decode", "idle_in_host_ns")
