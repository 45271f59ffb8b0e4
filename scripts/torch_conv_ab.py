#!/usr/bin/env python3
"""Time the port's int8 conv kernels from one checkout, for A/B comparisons.

    python3 scripts/torch_conv_ab.py [ROOT]

ROOT (default: this checkout) holds the package
``simple_image_compression_network_tpu_torch``; its kernels are built there.
Prints the card's name and power limit, the conv kernels' ptxas register
lines, and per layer and in sum, for kernel A at the eight layer forms of
the default plan and, where ROOT has it, kernel F at the eight layers of
the ``pallas3`` plan (B = 2, 768x512, random seeded inputs): the kernel's
device time (CUDA events around 20 calls queued behind a spin kernel, after
one warm-up, of a call that launches the kernel alone: with the weights
packed ahead where ROOT's wrappers pack them) and the wrapper's time a call
(CUDA events, mean of 50, which holds the host's time where it exceeds the
card's).  To compare
two checkouts, unpack the other one (``git archive``) into a directory that
.gitignore lists and run both on one card, one after the other, in turns:
other, this, this, other.  Needs a CUDA card; imports torch and numpy only.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import numpy as np
import torch

# (C, N, grid) of kernel A's default-plan layer forms; (kind, grid, ci, o)
# of the layers of the pallas3 plan (kernel F).
A_FORMS = [(12, 128, 384, 256), (512, 128, 192, 128), (512, 128, 96, 64),
           (512, 192, 48, 32), (192, 512, 48, 32), (128, 512, 96, 64),
           (128, 512, 192, 128), (512, 48, 192, 128)]
F_LAYERS = [("conv", 768, 512, 3, 128), ("conv", 384, 256, 128, 128),
            ("conv", 192, 128, 128, 128), ("conv", 96, 64, 128, 192),
            ("deconv", 48, 32, 192, 128), ("deconv", 96, 64, 128, 128),
            ("deconv", 192, 128, 128, 128), ("deconv", 384, 256, 128, 3)]


def cuda_ms(fn, iters: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 20) -> float:
    """Device time a call of fn(), which launches one kernel: the calls
    wait behind a spin kernel (``torch.cuda._sleep``) until all are
    queued, so the host's time stays out of the window."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()     # the spin outlasted the queueing
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("the spin kernel never outlasted the queueing")


def report(what: str, root: str, card: str, calls) -> None:
    """calls: (a call of the kernel alone, the wrapper's call) per layer."""
    k = [kernel_ms(fn) for fn, _ in calls]
    w = [cuda_ms(fn) for _, fn in calls]
    print(f"{what} [{root}, {card}]: kernel sum {sum(k):.4f} ms, per layer "
          f"{[round(v, 4) for v in k]}; wrapper sum {sum(w):.4f} ms, per "
          f"layer {[round(v, 4) for v in w]}", flush=True)


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), ".."))
    if not torch.cuda.is_available():
        print("CUDA is not available: this script times kernels on a card")
        return 2
    sys.path.insert(0, root)
    from simple_image_compression_network_tpu_torch import _build
    from simple_image_compression_network_tpu_torch.ops import (conv_fast,
                                                                cuda_conv)
    _, log = _build.build()
    _build.lib()
    for line in log.splitlines():
        if "registers" in line:
            print("  ptxas:", line.strip())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)

    def rand(shape, lo=-128, hi=128):
        return torch.from_numpy(rng.integers(lo, hi, shape,
                                             dtype=np.int8)).cuda()

    calls = []
    for c, n, gx, gy in A_FORMS:
        x, w3, b = rand((2, gx, gy, c)), rand((3, 3, c, n), -8, 8), rand((n,))
        wrapper = functools.partial(cuda_conv.conv3x3_s1_int8, x, w3, b)
        kernel = wrapper
        if hasattr(cuda_conv, "pack_conv3x3"):      # the wrapper packs
            kernel = functools.partial(cuda_conv._conv3x3, x, w3, b, True,
                                       False, False,
                                       cuda_conv.pack_conv3x3(w3))
        calls.append((kernel, wrapper))
    report("kernel A, default forms", root, card, calls)
    if not hasattr(cuda_conv, "conv_sparse_int8"):
        return 0
    calls = []
    for kind, gx, gy, ci, o in F_LAYERS:
        x, w, b = rand((2, gx, gy, ci)), rand((o, 5, 5, ci), -8, 8), rand((o,))
        if kind == "conv":
            xf = conv_fast.space_to_depth(x).contiguous()
            taps, wt = cuda_conv.conv_taps_s2d(w)
            bf, nb = b, 1
        else:
            xf = x
            taps, wt = cuda_conv.deconv_taps_d2s(w)
            bf, nb = conv_fast.tile_bias(b, 4), 4
        wt = wt.contiguous()
        wrapper = functools.partial(cuda_conv.conv_sparse_int8, xf, wt, bf,
                                    taps, nb)
        kernel = wrapper
        if hasattr(cuda_conv, "pack_taps"):         # the wrapper packs
            kernel = functools.partial(
                cuda_conv._conv_sparse, xf, wt, bf, taps, nb, True, False,
                False, cuda_conv.pack_taps(wt, taps, nb, xf.shape[3]))
        calls.append((kernel, wrapper))
    report("kernel F, pallas3 layers", root, card, calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
