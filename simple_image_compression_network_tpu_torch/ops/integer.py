"""Exact integer numerics — the golden contract for the bit-exact decode path.

The port's own copy of the JAX package's ``ops/integer.py`` (numpy only):
the third reference, independent of both torch and the kernels.

The reference accumulates MACs in the 8-bit activation type, i.e. the
accumulator wraps mod 256 *during* accumulation (``conv.hpp:110-117`` — the
golden model's ``TO tmp`` is ``ap_int<8>``; the hardware path likewise via
``Slice<ap_int<8>>``, ``conv_nonsquare_top.cpp:261``).  Because addition is
associative mod 256, accumulating in int32 and wrapping once at the end is
bit-identical; the tests property-test that equivalence, and this module
defines the wrap/bias/ReLU epilogue everything else is tested against.

A second exactness fact this build relies on: mod 256, re-interpreting a uint8
activation as int8 changes each product ``w*x`` by ``w*256`` when ``x >= 128``,
which is ``0 mod 256`` — so int8 x int8 convolution (the tensor cores' type)
wraps to the same 8-bit result as the reference's uint8 x int4 MAC.
``wrap_to_int8`` is the single place the wrap is defined.

All feature maps here are ``(N, X, Y, C)`` numpy arrays; weights are
``[O, kx, ky, I]`` (the unpacked layout of ``conv3_nonsquare_tb.cpp:538-571``).
"""

from __future__ import annotations

import numpy as np


def _wire(x: np.ndarray) -> np.ndarray:
    """uint8 wire activations; int8 input is reinterpreted, not cast."""
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype == np.int8 else x.astype(np.uint8)


def wrap_to_int8(acc: np.ndarray) -> np.ndarray:
    """Wrap an integer array mod 256 into int8 ([-128, 127])."""
    return ((acc.astype(np.int64) + 128) % 256 - 128).astype(np.int8)


def bias_relu_epilogue(acc: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """The reference's layer epilogue: wrap, add int8 bias (wraps again), MSB-ReLU.

    Matches ``conv_nonsquare_top.cpp:267-278`` (conv) / ``:183-194`` (deconv):
    the bias add happens on the packed 8-bit field, then the value is zeroed if
    its sign bit is set.  Golden equivalent: ``out += BIAS; if (out<0) out=0``
    (``conv3_nonsquare_tb.cpp:613-625``).  acc: int accumulator (any width),
    bias: int8 per-out-channel, broadcast over trailing channel dim.
    """
    out = wrap_to_int8(acc.astype(np.int64) + bias.astype(np.int64))
    return np.maximum(out, 0).astype(np.int8)


def conv2d_golden(x: np.ndarray, w: np.ndarray, bias: np.ndarray,
                  stride: int = 2, padding: int = 2) -> np.ndarray:
    """Scalar golden strided conv, bit-exact to ``verify_conv2d``.

    x: (N, X, Y, Cin) uint8 (wire format; int8 input is re-interpreted as
       uint8 exactly like the reference's padding buffer,
       ``conv3_nonsquare_tb.cpp:581-599``)
    w: (O, kx, ky, I) int weights (int4 values)
    bias: (O,) int8
    Returns (N, OX, OY, O) int8, non-negative (post-ReLU).
    """
    xu = _wire(x)
    n, ix, iy, ci = xu.shape
    o, k, _, ci2 = w.shape
    assert ci == ci2
    xp = np.zeros((n, ix + 2 * padding, iy + 2 * padding, ci), np.int64)
    xp[:, padding:padding + ix, padding:padding + iy, :] = xu
    ox = (ix + 2 * padding - k) // stride + 1
    oy = (iy + 2 * padding - k) // stride + 1
    wl = w.astype(np.int64)
    acc = np.zeros((n, ox, oy, o), np.int64)
    # out[n,x,y,h] = sum_{kx,ky,c} img[n, x*s+kx, y*s+ky, c] * w[h,kx,ky,c]
    # (conv.hpp:105-123)
    for kx in range(k):
        for ky in range(k):
            patch = xp[:, kx:kx + stride * ox:stride, ky:ky + stride * oy:stride, :]
            acc += np.einsum("nxyc,oc->nxyo", patch, wl[:, kx, ky, :])
    return bias_relu_epilogue(acc, bias)


def conv2d_golden_dilated(x: np.ndarray, w: np.ndarray, bias: np.ndarray,
                          stride: int = 1, padding: int = 0,
                          dilation: tuple = (2, 1)) -> np.ndarray:
    """Scalar golden dilated conv (kernel-tap dilation).

    Parity op for ``ConvolutionInputGenerator_NonSquare_Dilated``
    (the reference's ``slidingwindow.h:1529-1631``), whose window generator
    strides kernel taps by Dilation_x along x (Dilation_y is asserted 1
    there, :1535; this golden supports both axes).  Same uint8-in /
    wrap+bias+MSB-ReLU-out integer contract as ``conv2d_golden``.
    """
    xu = _wire(x)
    n, ix, iy, ci = xu.shape
    o, k, _, ci2 = w.shape
    assert ci == ci2
    dx, dy = dilation
    xp = np.zeros((n, ix + 2 * padding, iy + 2 * padding, ci), np.int64)
    xp[:, padding:padding + ix, padding:padding + iy, :] = xu
    ekx, eky = dx * (k - 1) + 1, dy * (k - 1) + 1  # effective extents
    ox = (ix + 2 * padding - ekx) // stride + 1
    oy = (iy + 2 * padding - eky) // stride + 1
    wl = w.astype(np.int64)
    acc = np.zeros((n, ox, oy, o), np.int64)
    for kx in range(k):
        for ky in range(k):
            patch = xp[:, kx * dx:kx * dx + stride * ox:stride,
                       ky * dy:ky * dy + stride * oy:stride, :]
            acc += np.einsum("nxyc,oc->nxyo", patch, wl[:, kx, ky, :])
    return bias_relu_epilogue(acc, bias)


def zero_insert_upsample(x: np.ndarray, stride: int = 2, padding: int = 2
                         ) -> np.ndarray:
    """deconv522's input expansion: zero-insert + append + outer pad.

    For input extent D: inner zero-insertion to 2D-1
    (``conv_nonsquare_top.cpp:110-127``), one zero row/col appended
    bottom/right to 2D (``:130-151``), then outer pad by k-p-1=2 on all sides
    to 2D+4 (``:154-156``).  Equivalently (the golden model's formulation,
    ``conv3_nonsquare_tb.cpp:700-718``): a (2D+2p) buffer where position
    p+2i holds input[i] and everything else is zero.
    """
    k = 5
    outer = k - padding - 1  # = 2
    n, ix, iy, c = x.shape
    ex, ey = stride * ix + 2 * outer, stride * iy + 2 * outer
    xp = np.zeros((n, ex, ey, c), x.dtype)
    xp[:, outer:outer + stride * ix:stride, outer:outer + stride * iy:stride, :] = x
    return xp


def deconv2d_golden(x: np.ndarray, w: np.ndarray, bias: np.ndarray,
                    stride: int = 2, padding: int = 2) -> np.ndarray:
    """Scalar golden transposed conv (deconv522), bit-exact to ``verify_deconv2d``.

    Zero-insertion upsample followed by a stride-1 5x5 VALID conv with the
    weights as given (cross-correlation, no kernel flip) and the same
    wrap/bias/ReLU epilogue.
    """
    xu = _wire(x)
    xp = zero_insert_upsample(xu, stride, padding).astype(np.int64)
    o, k, _, ci = w.shape
    n, ex, ey, _ = xp.shape
    ox, oy = ex - k + 1, ey - k + 1
    wl = w.astype(np.int64)
    acc = np.zeros((n, ox, oy, o), np.int64)
    for kx in range(k):
        for ky in range(k):
            acc += np.einsum("nxyc,oc->nxyo",
                             xp[:, kx:kx + ox, ky:ky + oy, :], wl[:, kx, ky, :])
    return bias_relu_epilogue(acc, bias)


def conv2d_golden_wrapping_acc(x: np.ndarray, w: np.ndarray, bias: np.ndarray,
                               stride: int = 2, padding: int = 2) -> np.ndarray:
    """Literal transcription of the reference accumulation: int8 accumulator
    that wraps after *every* MAC (``conv.hpp:110-117``).  Slow; exists only to
    property-test that wide-accumulate-then-wrap is equivalent.
    """
    xu = _wire(x)
    n, ix, iy, ci = xu.shape
    o, k, _, _ = w.shape
    xp = np.zeros((n, ix + 2 * padding, iy + 2 * padding, ci), np.uint8)
    xp[:, padding:padding + ix, padding:padding + iy, :] = xu
    ox = (ix + 2 * padding - k) // stride + 1
    oy = (iy + 2 * padding - k) // stride + 1
    out = np.zeros((n, ox, oy, o), np.int8)
    for ni in range(n):
        for xi in range(ox):
            for yi in range(oy):
                for h in range(o):
                    tmp = np.int8(0)
                    for kx in range(k):
                        for ky in range(k):
                            for c in range(ci):
                                p = int(xp[ni, xi * stride + kx, yi * stride + ky, c]) \
                                    * int(w[h, kx, ky, c])
                                tmp = wrap_to_int8(np.int64(int(tmp) + p))
                    v = wrap_to_int8(np.int64(int(tmp) + int(bias[h])))
                    out[ni, xi, yi, h] = max(v, np.int8(0))
    return out
