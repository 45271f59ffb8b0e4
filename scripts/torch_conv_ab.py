#!/usr/bin/env python3
"""Time the port's int8 conv kernels from one checkout, for A/B comparisons.

    python3 scripts/torch_conv_ab.py [ROOT]

ROOT (default: this checkout) holds the package
``simple_image_compression_network_tpu_torch``; its kernels are built there.
Prints the ptxas register lines of the build, kernel A's time at the eight
layer forms of the default plan and, where ROOT has it, kernel F's time at
the eight layers of the ``pallas3`` plan (B = 2, 768x512, random seeded
inputs, CUDA events, mean of 50 launches after one warm-up).  To compare two
checkouts, unpack the other one (``git archive``) into a directory that
.gitignore lists and run both on one card, one after the other, in turns:
other, this, this, other.  Needs a CUDA card; imports torch and numpy only.
"""

from __future__ import annotations

import os
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
    rng = np.random.default_rng(0)

    def rand(shape, lo=-128, hi=128):
        return torch.from_numpy(rng.integers(lo, hi, shape,
                                             dtype=np.int8)).cuda()

    per = []
    for c, n, gx, gy in A_FORMS:
        x, w3, b = rand((2, gx, gy, c)), rand((3, 3, c, n), -8, 8), rand((n,))
        per.append(cuda_ms(lambda: cuda_conv.conv3x3_s1_int8(x, w3, b)))
    card = torch.cuda.get_device_name(0)
    print(f"kernel A, default forms [{root}, {card}]: sum {sum(per):.4f} "
          f"ms, per form {[round(v, 4) for v in per]}")
    if not hasattr(cuda_conv, "conv_sparse_int8"):
        return 0
    per = []
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
        per.append(cuda_ms(lambda: cuda_conv.conv_sparse_int8(xf, wt, bf,
                                                              taps, nb)))
    print(f"kernel F, pallas3 layers [{root}, {card}]: sum {sum(per):.4f} "
          f"ms, per layer {[round(v, 4) for v in per]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
