"""Plain reference of the int8 codec: the reference's 8-layer integer
autoencoder and the entropy stage's containers, read back.

The transform is written from the reference's integer contract
(``config_nonsquare.h``, ``conv.hpp``): uint8 wire activations, int4
weights [O, kx, ky, I], int8 biases, an accumulator that wraps mod 256, the
bias added on the 8-bit field, then a ReLU on the sign bit.  Four 5x5/s2/p2
convs, then four transposed convs as a zero-insert upsample (input i at
2 + 2i of a 2D + 4 buffer) and a 5x5 VALID cross-correlation.

The sums are float32 matrix products of the weights and the unfolded
patches (``F.unfold``; a transposed conv scatters each input position's
products back with ``F.fold``), with TF32 off.  They are exact: every
product is an integer of magnitude at most 255 * 8, and no partial sum of
a layer exceeds 128 * 25 * 255 * 8 = 6,528,000 < 2^24, so float32 holds
each one exactly whatever the order of summation.  (A cuDNN convolution
may take an FFT or Winograd algorithm, which rounds; a product of
unfolded patches does not.)

The containers are decoded by ``rans_plain`` with the model's static
tables (``latent_cdfs.npz``; lane k codes channel k % C).  Nothing here
imports the program.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

import rans_plain

CODEC_INT8 = 1
BLOCK = 8          # images a reference call holds at once


class _fp32:
    """float32 products without TF32 (cuBLAS rounds TF32's inputs to 10
    bits; exact here too, but the reference states float32)."""

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was


class Reference:
    """The int8 codec's reference on ``device``: weights and tables read
    from the raw files both sides read."""

    def __init__(self, cfg: dict, root: str, device):
        self.device = torch.device(device)
        with np.load(os.path.join(root, cfg["weights"])) as z:
            p = {k: z[k] for k in z.files}
        # [O, kx, ky, I] -> conv2d's (O, I, kx, ky), float32 (exact)
        self.w = [torch.from_numpy(p[f"w{i}"].astype(np.float32))
                  .permute(0, 3, 1, 2).contiguous().to(self.device)
                  for i in range(8)]
        self.b = [torch.from_numpy(p[f"b{i}"].astype(np.int64))
                  .to(self.device) for i in range(8)]
        with np.load(os.path.join(root, cfg["tables"])) as z:
            self.cdfs = torch.from_numpy(z["cdfs"].astype(np.int64)).to(
                self.device)
        self.act_bits = 8     # the control sets 4

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        """An activation as the next layer reads it: 8 bits, or the
        control's top bits only."""
        if self.act_bits < 8:
            drop = 8 - self.act_bits
            h = (h.to(torch.int64) >> drop) << drop
        return h.to(torch.float32)

    def _epilogue(self, acc: torch.Tensor, i: int) -> torch.Tensor:
        # the wrapped accumulator plus the bias, wrapped again, is the sum
        # wrapped once (mod 256); then the ReLU on the sign bit
        v = acc.to(torch.int64) + self.b[i][None, :, None, None]
        return ((v + 128) % 256 - 128).clamp(min=0)

    def _conv(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """Layer i, a 5x5/s2/p2 conv: (B, C, X, Y) -> (B, O, X/2, Y/2)."""
        b, _, x, y = h.shape
        cols = F.unfold(self._act(h), 5, padding=2, stride=2)
        w = self.w[i].reshape(self.w[i].shape[0], -1)
        return self._epilogue((w @ cols).reshape(b, -1, x // 2, y // 2), i)

    def _deconv(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """Layer i, a transposed conv: input position j meets tap k at
        output 2j + 2 - k (the zero-insert upsample's VALID correlation),
        so each input position's products with the flipped kernel fold
        back at stride 2, padding 2: (B, C, D, E) -> (B, O, 2D, 2E)."""
        b, c, dx, dy = h.shape
        w = self.w[i].flip(2, 3)                        # (O, I, 5, 5)
        o = w.shape[0]
        wt = w.permute(0, 2, 3, 1).reshape(o * 25, c)  # rows (o, a, b)
        cols = wt @ self._act(h).reshape(b, c, dx * dy)
        out = F.fold(cols, (2 * dx, 2 * dy), 5, padding=2, stride=2)
        return self._epilogue(out, i)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, 3) uint8 -> (B, X/16, Y/16, C) int64 latent."""
        h = x.to(self.device).permute(0, 3, 1, 2).to(torch.int64)
        if x.dtype == torch.int8:
            h = h % 256                               # wire: reinterpreted
        with _fp32():
            for i in range(4):
                h = self._conv(h, i)
        return h.permute(0, 2, 3, 1)

    def synthesis(self, z: torch.Tensor) -> torch.Tensor:
        """(B, zx, zy, C) latent -> (B, 16 zx, 16 zy, 3) int64."""
        h = z.to(self.device).permute(0, 3, 1, 2).to(torch.int64)
        with _fp32():
            for i in range(4, 8):
                h = self._deconv(h, i)
        return h.permute(0, 2, 3, 1)

    def read(self, blobs: Sequence[bytes]):
        """Containers of one geometry -> (latents (B, zx, zy, C) int64,
        streams rejected)."""
        streams, shape = [], None
        for blob in blobs:
            cid, sec = rans_plain.unpack_container(blob)
            if cid != CODEC_INT8 or len(sec) != 3 or sec[1]:
                raise ValueError("not a static-table int8 container")
            hdr = struct.unpack("<HHHHH", sec[0])
            if shape not in (None, hdr):
                raise ValueError("mixed geometries")
            shape = hdr
            streams += rans_plain.unpack_streams(sec[2])
        _, _, zx, zy, c = shape
        n_lanes = rans_plain.stream_shape(streams[0])[1]
        lane_rows = torch.arange(n_lanes, device=self.device) % c
        syms, ok = rans_plain.decode(streams, lane_rows, self.cdfs)
        z = syms.reshape(len(blobs), zx, zy, c)
        return z, int((~ok).sum())

    # --- the comparisons ------------------------------------------------
    def judge(self, blobs: Sequence[bytes], sigma_of=None, x=None,
              x_hat=None, y_hat=None) -> Dict[str, float]:
        """Read the program's containers here.  With the source images
        ``x``: the latents read must be this reference's latents of x,
        exactly.  With the program's reconstructions ``x_hat`` of these
        containers: this reference's synthesis of the latents read,
        exactly.  (``sigma_of`` and ``y_hat`` belong to the hyperprior's
        reference.)"""
        out = {"streams_rejected": 0}
        if x is not None:
            out["z_mismatch"] = 0
        if x_hat is not None:
            out["x_mismatch"] = 0
        for i in range(0, len(blobs), BLOCK):
            z, bad = self.read(blobs[i:i + BLOCK])
            out["streams_rejected"] += bad
            if x is not None:
                ref = self.analysis(x[i:i + BLOCK])
                out["z_mismatch"] += int((z != ref).sum())
            if x_hat is not None:
                ref = self.synthesis(z)
                got = x_hat[i:i + BLOCK].to(self.device).to(torch.int64)
                out["x_mismatch"] += (int((got != ref).sum())
                                      if got.shape == ref.shape
                                      else ref.numel())
        return out

    def control(self, x: torch.Tensor) -> Dict[str, float]:
        """The control: this reference in the program's place with int4
        activations, read by the same comparisons (the latent against the
        8-bit latent; the reconstruction of the 8-bit latent)."""
        out = {"streams_rejected": 0, "z_mismatch": 0, "x_mismatch": 0}
        for i in range(0, x.shape[0], BLOCK):
            xb = x[i:i + BLOCK]
            self.act_bits = 8
            z8 = self.analysis(xb)
            x8 = self.synthesis(z8)
            self.act_bits = 4
            try:
                out["z_mismatch"] += int((self.analysis(xb) != z8).sum())
                out["x_mismatch"] += int((self.synthesis(z8) != x8).sum())
            finally:
                self.act_bits = 8
        return out

