"""The scale hyperprior's work: the operations and bytes its transforms
need, from its layer shapes, and its entry points in the program.

Counting as for the int8 net: a conv over its output positions, a 5x5/s2
transposed conv over its INPUT positions; GDN and IGDN as their C x C
channel mix at each position (the square, sqrt and divide are left out).
At 768x512, N = 128, M = 192: g_a and g_s each 14.47 GMAC plus 2.11 of
(I)GDN, h_a and h_s 0.54 each.  Encode is g_a + h_a + h_s (the encoder
derives the scales itself), 17.66 GMAC an image; decode is h_s + g_s,
17.12.  Bytes: the direction's float32 input and output once and the
float32 weights.
"""

from __future__ import annotations

import os

import torch

N, M = 128, 192


def _stages(height: int, width: int) -> dict:
    """MACs an image by stage."""
    h, w = height, width
    g = 0
    for cin, cout in ((3, N), (N, N), (N, N), (N, M)):
        h, w = h // 2, w // 2
        g += h * w * 25 * cin * cout
    gdn = sum((height >> k) * (width >> k) * N * N for k in (1, 2, 3))
    yx, yy = height // 16, width // 16
    h_a = (yx * yy * 9 * M * N + (yx // 2) * (yy // 2) * 25 * N * N
           + (yx // 4) * (yy // 4) * 25 * N * N)
    h_s = ((yx // 4) * (yy // 4) * 25 * N * N + (yx // 2) * (yy // 2) * 25
           * N * N + yx * yy * 9 * N * M)
    # g_s over its input positions: the mirror of g_a's output positions
    return {"g": g, "gdn": gdn, "h_a": h_a, "h_s": h_s}


def macs(direction: str, height: int, width: int) -> int:
    s = _stages(height, width)
    hyper = s["h_a"] + s["h_s"] if direction == "encode" else s["h_s"]
    return s["g"] + s["gdn"] + hyper


def ops(direction: str, height: int, width: int) -> float:
    return 2.0 * macs(direction, height, width)


def bytes_moved(direction: str, height: int, width: int) -> float:
    image = height * width * 3 * 4
    latent = (height // 16) * (width // 16) * M * 4
    hyper = (height // 64) * (width // 64) * N * 4
    weights = 4 * (4 * 25 * N * N + 3 * N * N + 2 * (25 * N * N + 9 * N * M))
    return float(image + latent + hyper + weights)


class Codec:
    """The system under test: ``HyperCodec`` on the card (float32, TF32
    off, deterministic cuDNN; kernels B, C, D, E), through
    ``codec/pipeline.py``."""

    def __init__(self, cfg: dict, root: str, device):
        from simple_image_compression_network_tpu_torch.codec import (
            hyper_codec, pipeline)
        path = os.path.join(root, cfg["weights"])
        if not os.path.exists(path):
            raise SystemExit(f"{cfg['weights']} is missing: the scale "
                             f"hyperprior's cells run its trained weights")
        self._pipeline = pipeline
        self.codec = hyper_codec.HyperCodec.from_checkpoint(path,
                                                            device=device)

    @staticmethod
    def inputs(bank):
        """The bank as the codec takes it: float32 in [0, 1]."""
        return bank.to(torch.float32) / 255.0

    def encoder(self, depth: int):
        return self._pipeline.HyperPipelinedEncoder(self.codec, depth=depth)

    def decoder(self, depth: int):
        return self._pipeline.HyperPipelinedDecoder(self.codec, depth=depth)

    @staticmethod
    def decoded(result):
        return result[0], result[1]

    def transform(self, direction: str, x):
        if direction == "encode":
            return lambda: self.codec.encode_arrays(x)
        y, z, _ = self.codec.encode_parts(x)
        y, z = y.float(), z.float()

        def decode():
            self.codec._prior_from_z(z)
            return self.codec.model.decode_arrays(y)
        return decode

    def sigma_of(self, z):
        """The program's scales of z (its h_s, image by image), the
        context source of its decoder."""
        return self.codec._prior_from_z(z.to(self.codec.device))[1]

