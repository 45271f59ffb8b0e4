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
                  pads=(1, 1, 1, 1), dilation=(1, 1),
                  groups: int = 1) -> torch.Tensor:
    """Exact int64 accumulator of a cross-correlation (no kernel flip, as
    ``lax.conv_general_dilated``).

    x: (B, X, Y, C) int8; w_hwio: (kx, ky, C / groups, O) int8;
    pads: (x_lo, x_hi, y_lo, y_hi) zero padding; dilation: the kernel taps'
    step along x and y; groups: as ``feature_group_count``.  Returns
    (B, X', Y', O).
    """
    xf = x.to(torch.int8).permute(0, 3, 1, 2).to(torch.float64)
    xf = F.pad(xf, (pads[2], pads[3], pads[0], pads[1]))
    wf = w_hwio.to(device=x.device, dtype=torch.int8).permute(3, 2, 0, 1)
    wf = wf.to(torch.float64)
    acc = F.conv2d(xf, wf, stride=stride, dilation=tuple(dilation),
                   groups=groups)
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


# float32 represents every partial sum exactly while taps*C*128*128 <= 2^24
_F32_EXACT = 1 << 24


def conv2d_int8_f32(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                    stride: int = 2, padding: int = 2) -> torch.Tensor:
    """The conv2d layer computed in float32: exact by range while every
    partial sum, |acc| <= k*k*I*128*128, fits float32's 24-bit mantissa
    (layer 0 of the net: 75 taps, < 2^21).  Wider layers are refused, as
    in the JAX package (``AssertionError``).

    On a CUDA tensor this is one float32 cuDNN conv with TF32 off and a
    deterministic algorithm (the scope of ``models/hyperprior.py``; the
    global flags are never changed), the counterpart of the JAX package's
    XLA conv; on the CPU it is the float64 form, ``conv2d_int8``."""
    k, ci = w.shape[1], w.shape[3]
    if k * k * ci * 128 * 128 > _F32_EXACT:
        raise AssertionError(f"a {k}x{k}x{ci} layer's sums can leave "
                             f"float32's exact range")
    if x.device.type == "cpu":
        return conv2d_int8(x, w, bias, stride=stride, padding=padding)
    xf = x.to(torch.int8).permute(0, 3, 1, 2).to(torch.float32)
    wf = w.to(device=x.device, dtype=torch.int8).permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        acc = F.conv2d(xf, wf.to(torch.float32), stride=stride,
                       padding=padding)
    return bias_relu_epilogue(acc.to(torch.int64).permute(0, 2, 3, 1), bias)


def conv2d_int8_dilated(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        *, stride: int = 1, padding: int = 0,
                        dilation=(2, 1)) -> torch.Tensor:
    """Dilated conv (kernel taps ``dilation`` apart, the reference's
    ``ConvolutionInputGenerator_NonSquare_Dilated``) with the integer
    contract, in the float64 golden form.  Golden:
    ``integer.conv2d_golden_dilated``."""
    p = padding
    return bias_relu_epilogue(
        conv_acc_hwio(x, _w_hwio(w), stride=stride, pads=(p, p, p, p),
                      dilation=dilation), bias)


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


def phase_taps(k: int = 5, padding: int = 2, stride: int = 2) -> list:
    """The deconv's sub-pixel phases: for output phase (px, py), the kernel
    taps (kx, ky) it reads and their input offsets (d, e), output pixel
    (2a+px, 2b+py) reading x[a+d, b+e]: kx of parity (lo - px) mod 2,
    d = (px + kx - lo) / 2, lo = k - padding - 1.  Phases in the order
    px*2 + py; 9/6/6/4 taps for the k5/s2/p2 layer."""
    lo = k - padding - 1
    out = []
    for px in range(stride):
        for py in range(stride):
            out.append([((px + kx - lo) // 2, (py + ky - lo) // 2, kx, ky)
                        for kx in range(k) if (kx - (lo - px)) % 2 == 0
                        for ky in range(k) if (ky - (lo - py)) % 2 == 0])
    return out


def interleave_phases(planes) -> torch.Tensor:
    """Four (B, X, Y, O) phase planes in the order px*2 + py -> (B, 2X,
    2Y, O), out[2a+px, 2b+py] = planes[px*2+py][a, b]."""
    b, x, y, o = planes[0].shape
    return (torch.stack(list(planes), 3).reshape(b, x, y, 2, 2, o)
            .permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * x, 2 * y, o))


def deconv2d_int8_acc_phased(x: torch.Tensor, w: torch.Tensor, *,
                             stride: int = 2, padding: int = 2
                             ) -> torch.Tensor:
    """deconv522 accumulator by sub-pixel (phase) decomposition: each of
    the 4 output phases is a small stride-1 conv (3x3, 3x2, 2x3 or 2x2
    taps) over the input, and the phases interleave.  The exact int64
    accumulator, in the float64 form on every device (no kernel emits an
    unwrapped accumulator).  Equal to ``deconv2d_int8_acc``."""
    w8 = w.to(torch.int8)
    planes = []
    for taps in phase_taps(w.shape[1], padding, stride):
        ds = sorted({t[0] for t in taps})
        es = sorted({t[1] for t in taps})
        sub = torch.zeros((len(ds), len(es)) + (w.shape[3], w.shape[0]),
                          dtype=torch.int8, device=w.device)
        for d, e, kx, ky in taps:
            sub[d - ds[0], e - es[0]] = w8[:, kx, ky, :].T
        planes.append(conv_acc_hwio(
            x, sub, stride=1, pads=(-ds[0], ds[-1], -es[0], es[-1])))
    return interleave_phases(planes)


def deconv2d_int8_phased(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, *, stride: int = 2,
                         padding: int = 2) -> torch.Tensor:
    """The deconv522 layer by phases: each phase is one launch of kernel F
    (``cuda_conv.conv_sparse_int8``: the phase's own 9/6/6/4-entry tap
    table, one output block of O columns, the epilogue fused in), then the
    four int8 planes interleave.  The epilogue is elementwise, so running
    it before the interleave is exact.  CPU tensors run F's plain
    version."""
    from . import cuda_conv
    if (stride, padding, w.shape[1]) != (2, 2, 5):
        raise ValueError("the phased deconv is the k5/s2/p2 layer")
    xi = to_wire_int8(x).contiguous()
    b8 = bias.to(device=xi.device, dtype=torch.int8).contiguous()
    planes = [cuda_conv.conv_sparse_int8(xi, wt.to(xi.device), b8, taps, 1)
              for taps, wt in cuda_conv.deconv_taps_phases(w)]
    return interleave_phases(planes)
