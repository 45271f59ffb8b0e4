"""Device time of one call alone: CUDA events around calls queued behind a
spin kernel, so that the host's time to queue them stays out of the
window (the method of the program's ``chip_smoke.py:kernel_ms``)."""

from __future__ import annotations

import torch


def kernel_ms(fn, iters: int = 3) -> tuple:
    """-> (mean device ms of fn() over ``iters`` calls after a warm call,
    how it was timed).  The spin must outlast the queueing (the start
    event not yet reached when the last call is queued); else it runs
    again 4 times longer.  A call that waits on the device itself can
    never be queued behind a spin: it is timed by events around the calls
    alone, which counts the device's waits for the host too.  Few calls:
    a call of the float transforms launches some hundreds of kernels, and
    the host blocks once about a thousand wait behind the spin."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters, "behind a spin"
        cycles *= 4
        if cycles > 1 << 30:
            break
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, "waits on the device: no spin"
