"""Every layer of the net as one 3x3/s1 int8 conv: the weight rewrites.

The PyTorch counterpart of the JAX package's ``ops/conv_fast.py``.  Both
layer types reduce to the fused 3x3/s1/SAME conv of ``ops/cuda_conv.py``
(kernel A on the card), so the whole transform runs on one kernel:

* strided 5x5/s2/p2 conv = 3x3/s1 conv over the space-to-depth input
  (``conv_weights_s2d``: ``W3[mx, my, (a,b,c), o] = w[o, 2mx+a, 2my+b, c]``,
  the missing (m=2, phase=1) taps are zero);
* transposed 5x5/s2 conv (deconv522) = 3x3/s1 conv with 4*O phase outputs,
  then depth-to-space (``deconv_weights_d2s``);
* two chained deconvs = the first one's phase form fed straight into
  ``deconv_weights_s2dtail`` (K = 4I, N = 16O), then one 4x4 interleave.

The JAX package's other mappings of the same contract run on kernels A and
F at other shapes: ``s4d`` (one 3x3/s1 conv over the 4x4 space-to-depth
input emitting the 4 output phases, kernel A at K = 9*16I, N = 4O), and two
single-tap products on kernel F: ``gemm`` (the s2d conv as one im2col
GEMM, K = 9*4I) and ``tapn`` (the deconv with its 9 taps folded into the
GEMM's N = 9*4O, then 9 shifted adds).  The JAX package computes those two
products with ``dot_general`` outside any Pallas kernel; the port runs them
on kernel F as a one-tap table, not on a library GEMM.

The epilogue is elementwise, so it runs on the phase forms with the bias
tiled over the phase blocks; the results are bit-identical to the direct
forms of ``ops/conv_int.py`` (tested).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_conv
from .conv_int import bias_relu_epilogue, to_wire_int8

# kernel F's table for a plain GEMM: the centre tap of the 3x3 window,
# one input block, one output block, weight slice 0
ONE_TAP = ((1, 1, 0, 0, 0),)


def as_int8(w) -> torch.Tensor:
    """Tensor or numpy array -> int8 tensor."""
    return torch.as_tensor(w).to(torch.int8)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 2V, 2W, C) -> (B, V, W, 4C), xs[v,w,(a,b,c)] = x[2v+a, 2w+b, c]."""
    b, x2, y2, c = x.shape
    v, w = x2 // 2, y2 // 2
    return (x.reshape(b, v, 2, w, 2, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, v, w, 4 * c))


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """(B, V, W, 4C) -> (B, 2V, 2W, C): inverse of space_to_depth."""
    b, v, w, c4 = y.shape
    c = c4 // 4
    return (y.reshape(b, v, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, 2 * v, 2 * w, c))


def depth_to_space4(y: torch.Tensor) -> torch.Tensor:
    """(B, V, W, 16C) -> (B, 4V, 4W, C): 4x4 fine offsets off the channels."""
    b, v, w, c16 = y.shape
    c = c16 // 16
    return (y.reshape(b, v, w, 4, 4, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, 4 * v, 4 * w, c))


def conv_weights_s2d(w) -> torch.Tensor:
    """[O, 5, 5, I] kernel -> (3, 3, 4I, O) HWIO kernel over s2d channels."""
    w = as_int8(w)
    o, k, _, ci = w.shape
    assert k == 5
    w3 = torch.zeros((3, 3, 4 * ci, o), dtype=torch.int8, device=w.device)
    for mx in range(3):
        for a in range(2):
            kx = 2 * mx + a
            if kx >= k:
                continue
            for my in range(3):
                for b in range(2):
                    ky = 2 * my + b
                    if ky >= k:
                        continue
                    g = (a * 2 + b) * ci
                    w3[mx, my, g:g + ci, :] = w[:, kx, ky, :].T
    return w3


def deconv_weights_d2s(w) -> torch.Tensor:
    """[O, 5, 5, I] deconv kernel -> (3, 3, I, 4O) HWIO kernel whose output
    channels are the 4 phases (px, py, o): output phase (px, py) at
    (2i+px) reads input offset d = (px + kx - 2)/2 for kx of parity
    (2 - px) mod 2."""
    w = as_int8(w)
    o, k, _, ci = w.shape
    assert k == 5
    lo = 2  # k - padding - 1
    w3 = torch.zeros((3, 3, ci, 4 * o), dtype=torch.int8, device=w.device)
    for px in range(2):
        for py in range(2):
            for kx in range(k):
                if (kx - (lo - px)) % 2:
                    continue
                d = (px + kx - lo) // 2
                for ky in range(k):
                    if (ky - (lo - py)) % 2:
                        continue
                    e = (py + ky - lo) // 2
                    g = (px * 2 + py) * o
                    w3[d + 1, e + 1, :, g:g + o] = w[:, kx, ky, :].T
    return w3


def deconv_weights_s2dtail(w) -> torch.Tensor:
    """[O, 5, 5, I] deconv kernel -> (3, 3, 4I, 16O) HWIO kernel consuming
    the upstream deconv's phase form (input channels (rx, ry, c)) and
    emitting the 4x4 fine offsets (ax, ay, o) of this layer's output:
    kx = 4*(u-v) + 2r + 2 - a, valid when 0 <= kx < 5."""
    w = as_int8(w)
    o, k, _, ci = w.shape
    assert k == 5
    w3 = torch.zeros((3, 3, 4 * ci, 16 * o), dtype=torch.int8,
                     device=w.device)
    for ax in range(4):
        for rx in range(2):
            for dx in (-1, 0, 1):
                kx = 4 * dx + 2 * rx + 2 - ax
                if not 0 <= kx < k:
                    continue
                for ay in range(4):
                    for ry in range(2):
                        for dy in (-1, 0, 1):
                            ky = 4 * dy + 2 * ry + 2 - ay
                            if not 0 <= ky < k:
                                continue
                            gin = (rx * 2 + ry) * ci
                            gout = (ax * 4 + ay) * o
                            w3[dx + 1, dy + 1, gin:gin + ci,
                               gout:gout + o] = w[:, kx, ky, :].T
    return w3


def tile_bias(bias, reps: int) -> torch.Tensor:
    """Per-channel bias repeated over ``reps`` phase blocks (phase-major,
    the column order of the d2s / s2dtail rewrites)."""
    return as_int8(bias).repeat(reps)


def conv2d_int8_s2d(x: torch.Tensor, w, bias) -> torch.Tensor:
    """5x5/s2/p2 conv layer via space-to-depth + one 3x3/s1 conv."""
    w3 = conv_weights_s2d(w).to(x.device)
    return cuda_conv.conv3x3_s1_int8(
        space_to_depth(x.to(torch.int8)).contiguous(), w3,
        as_int8(bias).to(x.device))


def deconv2d_int8_d2s(x: torch.Tensor, w, bias) -> torch.Tensor:
    """deconv522 layer: one 3x3/s1 conv emitting the 4 phases (epilogue in
    phase form), then depth-to-space."""
    w3 = deconv_weights_d2s(w).to(x.device)
    y = cuda_conv.conv3x3_s1_int8(x.to(torch.int8).contiguous(), w3,
                                  tile_bias(bias, 4).to(x.device))
    return depth_to_space(y)


def deconv2d_int8_tail_fused(x: torch.Tensor, w_a, b_a, w_b, b_b
                             ) -> torch.Tensor:
    """Two chained deconv522 layers fused in the phase domain: the first
    layer's phase form is the space-to-depth of its output, so the second
    consumes it through ``deconv_weights_s2dtail`` and the inter-layer
    depth-to-space never materializes."""
    dev = x.device
    ha = cuda_conv.conv3x3_s1_int8(x.to(torch.int8).contiguous(),
                                   deconv_weights_d2s(w_a).to(dev),
                                   tile_bias(b_a, 4).to(dev))
    hb = cuda_conv.conv3x3_s1_int8(ha, deconv_weights_s2dtail(w_b).to(dev),
                                   tile_bias(b_b, 16).to(dev))
    return depth_to_space4(hb)


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """(B, 4V, 4W, C) -> (B, V, W, 16C): 4x4 cells onto channels."""
    b, x4, y4, c = x.shape
    if x4 % 4 or y4 % 4:
        raise ValueError(f"space_to_depth4 needs sides that are multiples "
                         f"of 4, got {(x4, y4)}")
    v, w = x4 // 4, y4 // 4
    return (x.reshape(b, v, 4, w, 4, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, v, w, 16 * c))


def conv_weights_s4d(w) -> torch.Tensor:
    """[O, 5, 5, I] k5/s2 kernel -> (3, 3, 16I, 4O) HWIO kernel over s4d
    channels producing all four output phases.

    Output pixel (2v+pi, 2w+pj) reads input row 4v + u, u = 2*pi + kx - 2
    in [-2, 5]: s4d tap m = floor(u/4), cell row a = u mod 4.  So
    W4[mx, my, (ax, ay, c), (pi, pj, o)] = w[o, kx, ky, c]."""
    w = as_int8(w)
    o, k, _, ci = w.shape
    assert k == 5
    w4 = torch.zeros((3, 3, 16 * ci, 4 * o), dtype=torch.int8,
                     device=w.device)
    for pi in range(2):
        for kx in range(k):
            ux = 2 * pi + kx - 2
            mx, ax = ux // 4 + 1, ux % 4   # +1: taps -1..1 -> kernel 0..2
            for pj in range(2):
                for ky in range(k):
                    uy = 2 * pj + ky - 2
                    my, ay = uy // 4 + 1, uy % 4
                    gin = (ax * 4 + ay) * ci
                    gout = (pi * 2 + pj) * o
                    w4[mx, my, gin:gin + ci, gout:gout + o] = w[:, kx, ky, :].T
    return w4


def conv2d_int8_s4d(x: torch.Tensor, w, bias) -> torch.Tensor:
    """k5/s2/p2 conv layer via one 3x3/s1 conv over s4d(x) (kernel A, the
    bias tiled over the 4 phases) + depth-to-space of the output phases.
    Sides must be multiples of 4."""
    xs = space_to_depth4(to_wire_int8(x)).contiguous()
    y = cuda_conv.conv3x3_s1_int8(xs, conv_weights_s4d(w).to(xs.device),
                                  tile_bias(bias, 4).to(xs.device))
    return depth_to_space(y)


def s2d_patches(x: torch.Tensor) -> torch.Tensor:
    """(B, 2V, 2W, C) -> (B, V, W, 9*4C) int8: the 3x3 im2col patches of the
    space-to-depth input (zero padding 1), tap t = mx*3 + my major, the
    row order of ``conv_weights_s2d(w).reshape(9*4C, O)``."""
    xs = space_to_depth(to_wire_int8(x))
    _, v, ww, _ = xs.shape
    xp = F.pad(xs, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, mx:mx + v, my:my + ww] for mx in range(3)
                      for my in range(3)], dim=-1)


def conv2d_int8_gemm_acc(x: torch.Tensor, w) -> torch.Tensor:
    """5x5/s2/p2 conv accumulator as one im2col GEMM over s2d patches
    (K = 9*4C): the exact int64 accumulator, in float64 on every device
    (every partial sum is an integer far below 2^53)."""
    patches = s2d_patches(x)
    b, v, ww, k = patches.shape
    wmat = conv_weights_s2d(w).to(x.device).reshape(k, -1)
    acc = patches.reshape(-1, k).to(torch.float64) @ wmat.to(torch.float64)
    return acc.round().to(torch.int64).reshape(b, v, ww, -1)


def gemm_operands(x: torch.Tensor, w) -> tuple:
    """Kernel F's operands of the ``gemm`` form: the s2d patches (B, V, W,
    K) and the weights (1, K, O), K = 9*4C zero-padded to a multiple of 16
    (108 -> 112 at the RGB layer), which is exact, so that the tile stages
    the patches with 16-byte copies."""
    patches = s2d_patches(x)
    k = patches.shape[3]
    pad = -k % 16
    wmat = conv_weights_s2d(w).to(patches.device).reshape(k, -1)
    if pad:
        patches, wmat = F.pad(patches, (0, pad)), F.pad(wmat, (0, 0, 0, pad))
    return patches.contiguous(), wmat.unsqueeze(0).contiguous()


def conv2d_int8_gemm(x: torch.Tensor, w, bias) -> torch.Tensor:
    """The conv layer as the im2col GEMM, run on kernel F as a one-tap
    table (one input block of K = 9*4C, the bias / MSB-ReLU epilogue fused
    in)."""
    patches, wt = gemm_operands(x, w)
    return cuda_conv.conv_sparse_int8(patches, wt,
                                      as_int8(bias).to(patches.device),
                                      ONE_TAP, 1)


def deconv_weights_tapn(w) -> torch.Tensor:
    """[O, 5, 5, I] deconv kernel -> (I, 9*4O) GEMM weights, tap-major:
    column block t*4O..(t+1)*4O holds the d2s phase-form weights of 3x3 tap
    t = dx*3 + dy (``deconv_weights_d2s`` column order inside each
    block), so slicing the GEMM output per tap yields shiftable phase
    planes."""
    w3 = deconv_weights_d2s(w)                       # (3, 3, I, 4O)
    ci, c4o = w3.shape[2], w3.shape[3]
    return w3.permute(2, 0, 1, 3).reshape(ci, 9 * c4o)


def deconv2d_int8_tapn(x: torch.Tensor, w, bias) -> torch.Tensor:
    """deconv522 with its 3x3 taps folded into the GEMM's N: one product
    with K = I, N = 9*4O on kernel F (one-tap table, no ReLU, zero bias),
    which gives the tap planes wrapped to int8; then 9 spatially shifted
    adds, the bias and MSB-ReLU, and depth-to-space.  wrap is a ring
    homomorphism mod 256: wrap(acc + b) == wrap(sum_t wrap(acc_t) + b).
    The adds run in int32 and wrap once (the same result mod 256; PyTorch
    makes no promise about int8 overflow)."""
    xi = to_wire_int8(x).contiguous()
    wt = deconv_weights_tapn(w).to(xi.device)
    n = wt.shape[1]
    z = cuda_conv.conv_sparse_int8(
        xi, wt.unsqueeze(0).contiguous(),
        torch.zeros(n, dtype=torch.int8, device=xi.device), ONE_TAP, 1,
        relu=False)
    b, v, ww, _ = z.shape
    c4o = n // 9
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, v, ww, c4o), dtype=torch.int32, device=xi.device)
    for t in range(9):
        dx, dy = divmod(t, 3)
        acc += zp[:, dx:dx + v, dy:dy + ww, t * c4o:(t + 1) * c4o]
    return depth_to_space(bias_relu_epilogue(acc, tile_bias(bias, 4)))
