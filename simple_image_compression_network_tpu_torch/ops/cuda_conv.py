"""Fused 3x3/stride-1/SAME int8 conv: kernel A and its plain version.

The counterpart of the JAX package's ``ops/pallas_conv.py``
(``conv3x3_s1_int8_flat`` -> ``_flat_kernel``).  On a CUDA tensor the
wrapper launches the hand-written kernel of ``csrc/conv3x3_int8.cu``; on a
CPU tensor it runs the plain PyTorch version.  Only SAME padding is ported:
the ``x_valid``/``y_valid`` halo modes serve the spatially sharded
transform, which is not ported yet.
"""

from __future__ import annotations

import torch

from .. import _build
from .conv_int import conv_acc_hwio, wrap_to_int8

# |acc| <= 9 * C * 128 * 128 must stay below 2^31 in the kernel's int32.
_MAX_C = (1 << 31) // (9 * 128 * 128) - 1


def conv3x3_s1_int8_plain(x: torch.Tensor, w3: torch.Tensor,
                          bias: torch.Tensor, relu: bool = True
                          ) -> torch.Tensor:
    """Plain version: exact accumulator, wrap epilogue, MSB-ReLU."""
    acc = conv_acc_hwio(x, w3, stride=1, pads=(1, 1, 1, 1))
    out = wrap_to_int8(acc + bias.to(device=acc.device, dtype=torch.int64))
    return torch.clamp_min(out, 0) if relu else out


def conv3x3_s1_int8(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor,
                    relu: bool = True) -> torch.Tensor:
    """x (B, X, Y, C) int8, w3 (3, 3, C, N) int8 HWIO, bias (N,) int8 ->
    (B, X, Y, N) int8 = max(wrap(conv + bias), 0) (without the max when
    ``relu`` is False).

    CUDA tensors launch kernel A (counted in ``conv3x3_s1_int8.launches``);
    CPU tensors run the plain version (counted in ``.plain_runs``)."""
    if x.dim() != 4 or w3.dim() != 4 or bias.dim() != 1:
        raise ValueError("expected x (B,X,Y,C), w3 (3,3,C,N), bias (N,)")
    b, xd, yd, c = x.shape
    n = w3.shape[3]
    if tuple(w3.shape) != (3, 3, c, n) or bias.shape[0] != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w3 {tuple(w3.shape)}, bias {tuple(bias.shape)}")
    if not (x.dtype == w3.dtype == bias.dtype == torch.int8):
        raise TypeError("conv3x3_s1_int8 takes int8 x, w3 and bias")
    if not (x.device == w3.device == bias.device):
        raise ValueError("x, w3 and bias must be on one device")
    if x.device.type == "cpu":
        conv3x3_s1_int8.plain_runs += 1
        return conv3x3_s1_int8_plain(x, w3, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w3.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("conv3x3_s1_int8 takes contiguous tensors")
    if c > _MAX_C or b > 65535:
        raise ValueError(f"C={c} or B={b} outside the kernel's range")
    out = torch.empty((b, xd, yd, n), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.sicn_conv3x3_s1_int8(
            x.data_ptr(), w3.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, xd, yd, c, n, int(relu),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3_s1_int8")
    conv3x3_s1_int8.launches += 1
    return out


conv3x3_s1_int8.launches = 0
conv3x3_s1_int8.plain_runs = 0
