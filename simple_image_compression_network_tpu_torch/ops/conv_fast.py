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

The epilogue is elementwise, so it runs on the phase forms with the bias
tiled over the phase blocks; the results are bit-identical to the direct
forms of ``ops/conv_int.py`` (tested).
"""

from __future__ import annotations

import torch

from . import cuda_conv


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
