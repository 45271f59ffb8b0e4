"""Plain integer conv / transposed conv with the reference's wrap semantics.

The PyTorch counterpart of the JAX package's ``ops/conv_int.py``: int8
activations (NHWC), int8 weights holding int4 values in ``[O, kx, ky, I]``,
an exact integer accumulator, then the epilogue ``wrap(acc + bias)`` and
MSB-ReLU (``conv_nonsquare_top.cpp:267-278``).

These forms are the goldens of the port.  They compute the accumulator as a
float64 convolution: every partial sum is an integer of magnitude at most
``taps * C * 128 * 128`` (< 2^28 for every layer of the net), far inside
float64's 53-bit mantissa, so the rounded result is the exact integer sum
whatever order the backend adds in.  PyTorch's int8 ``F.conv2d`` is not used:
it returns int8 and its accumulator width is unspecified.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_wire_int8(x: torch.Tensor) -> torch.Tensor:
    """uint8 wire activations -> int8 by BITCAST (mod-256-preserving);
    a value cast would saturate or wrap differently per backend."""
    if x.dtype == torch.uint8:
        return x.view(torch.int8)
    return x.to(torch.int8)


def wrap_to_int8(acc: torch.Tensor) -> torch.Tensor:
    """Wrap an integer accumulator mod 256 into int8."""
    return (((acc & 0xFF) ^ 0x80) - 0x80).to(torch.int8)


def bias_relu_epilogue(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """wrap(acc + bias) then MSB-ReLU."""
    out = wrap_to_int8(acc.to(torch.int64)
                       + bias.to(device=acc.device, dtype=torch.int64))
    return torch.clamp_min(out, 0)


def conv_acc_hwio(x: torch.Tensor, w_hwio: torch.Tensor, *, stride: int = 1,
                  pads=(1, 1, 1, 1)) -> torch.Tensor:
    """Exact int64 accumulator of a cross-correlation (no kernel flip, as
    ``lax.conv_general_dilated``).

    x: (B, X, Y, C) int8; w_hwio: (kx, ky, C, O) int8;
    pads: (x_lo, x_hi, y_lo, y_hi) zero padding.  Returns (B, X', Y', O).
    """
    xf = x.to(torch.int8).permute(0, 3, 1, 2).to(torch.float64)
    xf = F.pad(xf, (pads[2], pads[3], pads[0], pads[1]))
    wf = w_hwio.to(device=x.device, dtype=torch.int8).permute(3, 2, 0, 1)
    wf = wf.to(torch.float64)
    acc = F.conv2d(xf, wf, stride=stride)
    return acc.round().to(torch.int64).permute(0, 2, 3, 1).contiguous()


def _w_hwio(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int8).permute(1, 2, 3, 0)


def conv2d_int8_acc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2,
                    padding: int = 2) -> torch.Tensor:
    """Direct strided conv accumulator (the 5x5/s2/p2 golden)."""
    p = padding
    return conv_acc_hwio(x, _w_hwio(w), stride=stride, pads=(p, p, p, p))


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                stride: int = 2, padding: int = 2) -> torch.Tensor:
    """The reference's conv2d layer, int8 -> int8."""
    return bias_relu_epilogue(
        conv2d_int8_acc(x, w, stride=stride, padding=padding), bias)


def deconv2d_int8_acc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2,
                      padding: int = 2) -> torch.Tensor:
    """deconv522 accumulator as an lhs-dilated conv.

    The reference zero-inserts the input (2D-1), appends one zero row/col
    (2D) and pads k-p-1 = 2 on each side (2D+4), then runs a VALID stride-1
    5x5 conv: lhs dilation 2 with padding (2, 3)."""
    k = w.shape[1]
    lo = k - padding - 1
    hi = lo + (stride - 1)
    b, xd, yd, c = x.shape
    dil = torch.zeros((b, stride * (xd - 1) + 1, stride * (yd - 1) + 1, c),
                      dtype=torch.int8, device=x.device)
    dil[:, ::stride, ::stride, :] = x.to(torch.int8)
    return conv_acc_hwio(dil, _w_hwio(w), stride=1, pads=(lo, hi, lo, hi))


def deconv2d_int8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                  stride: int = 2, padding: int = 2) -> torch.Tensor:
    """The reference's deconv522 layer."""
    return bias_relu_epilogue(
        deconv2d_int8_acc(x, w, stride=stride, padding=padding), bias)
