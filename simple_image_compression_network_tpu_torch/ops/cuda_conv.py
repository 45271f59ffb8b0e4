"""The int8 conv kernels of the port and the layer entry points on them.

The counterpart of the JAX package's ``ops/pallas_conv.py``.  Two kernels,
each with a plain PyTorch version and launch counters on its wrapper:

* kernel A (``csrc/conv3x3_int8.cu``): the fused 3x3/stride-1 int8 conv,
  ``conv3x3_s1_int8`` (also ``conv3x3_s1_int8_any``).  It stands for both
  TPU kernels of that contract, ``_conv3x3_kernel`` (lane layout) and
  ``_flat_kernel`` (flat-M layout): the layouts were the TPU's, and on the
  card both are one NHWC kernel.  SAME padding, or VALID on an axis whose
  input carries the 1-pixel halo (``x_valid``/``y_valid``);
* kernel F (``csrc/conv_sparse_int8.cu``): the block-sparse tap conv,
  ``conv_sparse_int8``, the counterpart of ``_sparse_kernel``.  It runs only
  the 25 real (tap, phase-block) products of a 5x5/s2 layer's s2d or d2s
  rewrite, which kernel A runs densely as 36.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs the plain version.  The layer entry points keep their JAX names and
the JAX parameter layout ([O, 5, 5, I] int8 weights, (O,) int8 bias), and
rewrite the weights per call, as the JAX package does:

* ``conv2d_int8_pallas`` / ``deconv2d_int8_pallas`` (TPU ``_conv3x3_kernel``)
  and ``conv2d_int8_pallas2`` / ``deconv2d_int8_pallas2`` (TPU
  ``_flat_kernel``): the s2d / d2s forms on kernel A.  The RGB output
  layer's 4*3 = 12 phase channels need no padding to 128 on the card;
* ``conv2d_int8_pallas3`` / ``deconv2d_int8_pallas3``: kernel F, with the
  halo modes of the spatially sharded net.  The JAX versions fall back to
  the dense kernels when ``ci % 128``, ``o % 128`` or ``xo % 8`` is not 0:
  those are TPU lane and tile constraints.  The port routes by plan name
  only, so every layer of the ``pallas3`` plan runs on kernel F, the RGB
  layers included; the results are bit-identical either way.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from . import conv_fast
from .conv_int import conv_acc_hwio, to_wire_int8, wrap_to_int8

# |acc| <= 9 * C * 128 * 128 must stay below 2^31 in the kernel's int32.
_MAX_C = (1 << 31) // (9 * 128 * 128) - 1
_MAX_TAPS = 32   # tap table entries per launch of kernel F (conv_taps.cuh)


def _check_int8_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     what: str) -> None:
    if not (x.dtype == w.dtype == bias.dtype == torch.int8):
        raise TypeError(f"{what} takes int8 x, weights and bias")
    if not (x.device == w.device == bias.device):
        raise ValueError("x, weights and bias must be on one device")


def _cuda_ready(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")


def _out_extent(n: int, valid: bool) -> int:
    out = n - 2 if valid else n
    if out <= 0:
        raise ValueError(f"extent {n} leaves no output with its halo")
    return out


def _epilogue(acc: torch.Tensor, bias: torch.Tensor, relu: bool
              ) -> torch.Tensor:
    out = wrap_to_int8(acc + bias.to(device=acc.device, dtype=torch.int64))
    return torch.clamp_min(out, 0) if relu else out


def conv3x3_s1_int8_plain(x: torch.Tensor, w3: torch.Tensor,
                          bias: torch.Tensor, relu: bool = True,
                          x_valid: bool = False, y_valid: bool = False
                          ) -> torch.Tensor:
    """Plain version of kernel A: exact accumulator, wrap epilogue,
    MSB-ReLU; no padding on an axis marked valid."""
    px, py = (0 if x_valid else 1), (0 if y_valid else 1)
    return _epilogue(conv_acc_hwio(x, w3, stride=1, pads=(px, px, py, py)),
                     bias, relu)


def conv3x3_s1_int8(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor,
                    relu: bool = True, x_valid: bool = False,
                    y_valid: bool = False) -> torch.Tensor:
    """x (B, X, Y, C) int8, w3 (3, 3, C, N) int8 HWIO, bias (N,) int8 ->
    (B, X, Y, N) int8 = max(wrap(conv + bias), 0) (without the max when
    ``relu`` is False).  With ``x_valid``/``y_valid`` the input already
    carries a 1-pixel halo on that axis and the conv is VALID there: the
    output is 2 shorter.

    CUDA tensors launch kernel A (counted in ``conv3x3_s1_int8.launches``);
    CPU tensors run the plain version (counted in ``.plain_runs``)."""
    if x.dim() != 4 or w3.dim() != 4 or bias.dim() != 1:
        raise ValueError("expected x (B,X,Y,C), w3 (3,3,C,N), bias (N,)")
    b, xd, yd, c = x.shape
    n = w3.shape[3]
    if tuple(w3.shape) != (3, 3, c, n) or bias.shape[0] != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w3 {tuple(w3.shape)}, bias {tuple(bias.shape)}")
    _check_int8_conv(x, w3, bias, "conv3x3_s1_int8")
    xo, yo = _out_extent(xd, x_valid), _out_extent(yd, y_valid)
    if x.device.type == "cpu":
        conv3x3_s1_int8.plain_runs += 1
        return conv3x3_s1_int8_plain(x, w3, bias, relu, x_valid, y_valid)
    _cuda_ready("conv3x3_s1_int8", x, w3, bias)
    if c > _MAX_C or b > 65535:
        raise ValueError(f"C={c} or B={b} outside the kernel's range")
    out = torch.empty((b, xo, yo, n), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.sicn_conv3x3_s1_int8(
            x.data_ptr(), w3.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, xd, yd, c, n, int(relu), int(x_valid), int(y_valid),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3_s1_int8")
    conv3x3_s1_int8.launches += 1
    return out


conv3x3_s1_int8.launches = 0
conv3x3_s1_int8.plain_runs = 0


def conv3x3_s1_int8_any(x: torch.Tensor, w3: torch.Tensor,
                        bias: torch.Tensor, relu: bool = True,
                        x_valid: bool = False, y_valid: bool = False
                        ) -> torch.Tensor:
    """The JAX package's backend-dispatching 3x3 (Pallas on a TPU, XLA
    elsewhere).  The card has one backend, kernel A: this is
    ``conv3x3_s1_int8``."""
    return conv3x3_s1_int8(x, w3, bias, relu, x_valid, y_valid)


def _check_taps(taps, n_taps: int, kb: int, c: int, n_blocks: int) -> None:
    """A tap table the kernel takes: entries (row, col, cblk, oblk, widx)
    in range, sorted by (oblk, cblk), and an int32-safe accumulator."""
    if not 0 < len(taps) <= _MAX_TAPS:
        raise ValueError(f"{len(taps)} taps: 1..{_MAX_TAPS} supported")
    per_block = [0] * n_blocks
    for e in taps:
        row, col, cblk, oblk, widx = e
        if not (0 <= row <= 2 and 0 <= col <= 2 and 0 <= cblk
                and (cblk + 1) * kb <= c and 0 <= oblk < n_blocks
                and 0 <= widx < n_taps):
            raise ValueError(f"tap {tuple(e)} out of range")
        per_block[oblk] += 1
    keys = [(e[3], e[2]) for e in taps]
    if keys != sorted(keys):
        raise ValueError("taps must be sorted by (output block, input block)")
    if max(per_block) * kb * 128 * 128 >= 1 << 31:
        raise ValueError("accumulator could leave int32")


def conv_sparse_int8_plain(x: torch.Tensor, w_taps: torch.Tensor,
                           bias: torch.Tensor, taps, n_blocks: int,
                           relu: bool = True, x_valid: bool = False,
                           y_valid: bool = False) -> torch.Tensor:
    """Plain version of kernel F: the tap table's GEMMs in float64 (every
    partial sum is an integer far below 2^53, so the result is exact),
    then the wrap epilogue per output block."""
    b, xd, yd, _ = x.shape
    _, kb, bn = w_taps.shape
    xo, yo = _out_extent(xd, x_valid), _out_extent(yd, y_valid)
    px, py = (0 if x_valid else 1), (0 if y_valid else 1)
    xp = F.pad(x.to(torch.float64), (0, 0, py, py, px, px))
    wf = w_taps.to(device=x.device, dtype=torch.float64)
    acc = torch.zeros((b, xo, yo, n_blocks, bn), dtype=torch.float64,
                      device=x.device)
    for row, col, cblk, oblk, widx in taps:
        a = xp[:, row:row + xo, col:col + yo, cblk * kb:(cblk + 1) * kb]
        acc[..., oblk, :] += a @ wf[widx]
    acc = acc.reshape(b, xo, yo, n_blocks * bn).round().to(torch.int64)
    return _epilogue(acc, bias, relu)


def conv_sparse_int8(x: torch.Tensor, w_taps: torch.Tensor,
                     bias: torch.Tensor, taps, n_blocks: int,
                     relu: bool = True, x_valid: bool = False,
                     y_valid: bool = False) -> torch.Tensor:
    """Block-sparse tap conv (kernel F).

    x (B, X, Y, C) int8 NHWC; w_taps (T, kb, bn) int8; bias
    (n_blocks*bn,) int8; taps: entries (row, col, cblk, oblk, widx), sorted
    by (oblk, cblk), each adding to output block oblk the product of the
    input channels [cblk*kb, (cblk+1)*kb) at offset (row, col) of the
    3x3 window with w_taps[widx].  Returns (B, Xo, Yo, n_blocks*bn) int8
    after the wrap/bias/ReLU epilogue; Xo = X (SAME) or X - 2 (``x_valid``:
    the input carries the 1-pixel halo), Yo likewise.

    CUDA tensors launch kernel F (``conv_sparse_int8.launches``); CPU
    tensors run the plain version (``.plain_runs``)."""
    if x.dim() != 4 or w_taps.dim() != 3 or bias.dim() != 1:
        raise ValueError("expected x (B,X,Y,C), w_taps (T,kb,bn), bias (N,)")
    b, xd, yd, c = x.shape
    n_taps, kb, bn = w_taps.shape
    if bias.shape[0] != n_blocks * bn:
        raise ValueError(f"bias has {bias.shape[0]} entries for "
                         f"{n_blocks} blocks of {bn}")
    _check_int8_conv(x, w_taps, bias, "conv_sparse_int8")
    taps = tuple(tuple(int(v) for v in e) for e in taps)
    _check_taps(taps, n_taps, kb, c, n_blocks)
    xo, yo = _out_extent(xd, x_valid), _out_extent(yd, y_valid)
    if x.device.type == "cpu":
        conv_sparse_int8.plain_runs += 1
        return conv_sparse_int8_plain(x, w_taps, bias, taps, n_blocks, relu,
                                      x_valid, y_valid)
    _cuda_ready("conv_sparse_int8", x, w_taps, bias)
    if b > 65535:
        raise ValueError(f"B={b} outside the kernel's range")
    out = torch.empty((b, xo, yo, n_blocks * bn), dtype=torch.int8,
                      device=x.device)
    if out.numel() == 0:
        return out
    table = (ctypes.c_int * (5 * len(taps)))(*[v for e in taps for v in e])
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.sicn_conv_sparse_int8(
            x.data_ptr(), w_taps.data_ptr(), bias.data_ptr(), out.data_ptr(),
            ctypes.addressof(table), len(taps), b, xd, yd, c, kb, bn,
            n_blocks, n_taps, int(relu), int(x_valid), int(y_valid),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv_sparse_int8")
    conv_sparse_int8.launches += 1
    return out


conv_sparse_int8.launches = 0
conv_sparse_int8.plain_runs = 0


def conv_taps_s2d(w) -> tuple:
    """[O, 5, 5, I] conv kernel -> (taps, w_taps (25, I, O)): the 25 real
    products over the s2d input's 4 phase blocks (a, b), one output block.
    Tap (mx, my) of block (a, b) is w[:, 2mx+a, 2my+b, :]; the missing
    2mx+a = 5 rows and columns are the zeros kernel A runs."""
    w = conv_fast.as_int8(w)
    taps, mats = [], []
    for a in range(2):
        for bph in range(2):
            for mx in range(3):
                for my in range(3):
                    kx, ky = 2 * mx + a, 2 * my + bph
                    if kx < 5 and ky < 5:
                        taps.append((mx, my, a * 2 + bph, 0, len(mats)))
                        mats.append(w[:, kx, ky, :].T)
    return tuple(taps), torch.stack(mats).contiguous()


def deconv_taps_d2s(w) -> tuple:
    """[O, 5, 5, I] deconv kernel -> (taps, w_taps (25, I, O)): output
    phase (px, py) is block px*2+py and reads input offset
    (d, e) = ((px+kx-2)/2, (py+ky-2)/2) for kx of parity (2-px) mod 2
    (the ``deconv_weights_d2s`` geometry): 9/6/6/4 taps."""
    w = conv_fast.as_int8(w)
    taps, mats = [], []
    for px in range(2):
        for py in range(2):
            for kx in range(5):
                if (kx - (2 - px)) % 2:
                    continue
                for ky in range(5):
                    if (ky - (2 - py)) % 2:
                        continue
                    d, e = (px + kx - 2) // 2, (py + ky - 2) // 2
                    taps.append((d + 1, e + 1, 0, px * 2 + py, len(mats)))
                    mats.append(w[:, kx, ky, :].T)
    return tuple(taps), torch.stack(mats).contiguous()


def _even_s2d(x: torch.Tensor) -> torch.Tensor:
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"the s2d form needs even extents, got "
                         f"{tuple(x.shape[1:3])}")
    return conv_fast.space_to_depth(to_wire_int8(x)).contiguous()


def conv2d_int8_pallas3(x: torch.Tensor, w, bias, *, x_valid: bool = False,
                        y_valid: bool = False) -> torch.Tensor:
    """Reference conv2d layer (k5/s2/p2) on kernel F over the s2d input.

    With ``x_valid``/``y_valid`` the input already carries a 2-pixel halo
    on that axis (the sharded net's exchange; 1 pixel of the s2d grid) and
    the conv is VALID there: output extent = (dim - 4) / 2."""
    xs = _even_s2d(x)
    taps, w_taps = conv_taps_s2d(w)
    return conv_sparse_int8(xs, w_taps.to(xs.device),
                            conv_fast.as_int8(bias).to(xs.device), taps, 1,
                            x_valid=x_valid, y_valid=y_valid)


def deconv2d_int8_pallas3(x: torch.Tensor, w, bias, *, x_valid: bool = False,
                          y_valid: bool = False) -> torch.Tensor:
    """Reference deconv522 layer on kernel F (one output block per phase,
    9/6/6/4 taps) + depth-to-space.

    With ``x_valid``/``y_valid`` the input carries a 1-pixel halo on that
    axis: output extent = 2 * (dim - 2)."""
    xi = to_wire_int8(x).contiguous()
    taps, w_taps = deconv_taps_d2s(w)
    y = conv_sparse_int8(xi, w_taps.to(xi.device),
                         conv_fast.tile_bias(bias, 4).to(xi.device), taps, 4,
                         x_valid=x_valid, y_valid=y_valid)
    return conv_fast.depth_to_space(y)


def conv2d_int8_pallas(x: torch.Tensor, w, bias) -> torch.Tensor:
    """Reference conv2d layer via s2d + kernel A (TPU ``_conv3x3_kernel``)."""
    return conv_fast.conv2d_int8_s2d(to_wire_int8(x), w, bias)


def deconv2d_int8_pallas(x: torch.Tensor, w, bias) -> torch.Tensor:
    """Reference deconv522 layer via kernel A + depth-to-space (TPU
    ``_conv3x3_kernel``)."""
    return conv_fast.deconv2d_int8_d2s(to_wire_int8(x), w, bias)


def conv2d_int8_pallas2(x: torch.Tensor, w, bias) -> torch.Tensor:
    """Reference conv2d layer via s2d + kernel A (TPU ``_flat_kernel``)."""
    return conv_fast.conv2d_int8_s2d(to_wire_int8(x), w, bias)


def deconv2d_int8_pallas2(x: torch.Tensor, w, bias) -> torch.Tensor:
    """Reference deconv522 layer via kernel A + depth-to-space (TPU
    ``_flat_kernel``)."""
    return conv_fast.deconv2d_int8_d2s(to_wire_int8(x), w, bias)
