"""The int8 configuration's work: the operations and bytes its transform
needs, from its layer shapes, and its entry points in the program.

Counting: a 5x5/s2 conv, 2 * out positions * K * K * Cin * Cout ops; a
5x5/s2 transposed conv over its INPUT positions, 2 * in positions * K * K
* Cin * Cout (each input value meets each tap once; the zeros that a
zero-insert form multiplies are no work the model needs).  At 768x512 each
direction is 14.47 GMAC an image.  Bytes: the direction's input and
output once, and the int4 weights held as int8.
"""

from __future__ import annotations

import os

import numpy as np

# (Cin, Cout) of the reference's eight 5x5/s2 layers (config_nonsquare.h)
ANALYSIS = ((3, 128), (128, 128), (128, 128), (128, 192))
SYNTHESIS = ((192, 128), (128, 128), (128, 128), (128, 3))
K = 5


def macs(direction: str, height: int, width: int) -> int:
    """Multiply-accumulates an image in one direction."""
    total, h, w = 0, height, width
    if direction == "encode":
        for cin, cout in ANALYSIS:
            h, w = h // 2, w // 2                       # output positions
            total += h * w * K * K * cin * cout
        return total
    h, w = height // 16, width // 16
    for cin, cout in SYNTHESIS:
        total += h * w * K * K * cin * cout             # input positions
        h, w = 2 * h, 2 * w
    return total


def ops(direction: str, height: int, width: int) -> float:
    return 2.0 * macs(direction, height, width)


def bytes_moved(direction: str, height: int, width: int) -> float:
    """An image's input and output once (uint8 pixels, int8 latent), plus
    the weights and biases."""
    image, latent = height * width * 3, (height // 16) * (width // 16) * 192
    layers = ANALYSIS if direction == "encode" else SYNTHESIS
    weights = sum(K * K * cin * cout + cout for cin, cout in layers)
    return float(image + latent) + weights


class Codec:
    """The system under test: the int8 codec on the card, static tables,
    the device coder, through ``codec/pipeline.py``."""

    def __init__(self, cfg: dict, root: str, device):
        from simple_image_compression_network_tpu_torch.codec import pipeline
        from simple_image_compression_network_tpu_torch.models import (
            codec_int)
        self._pipeline = pipeline
        self.net = codec_int.IntCodecNet.from_checkpoint(
            os.path.join(root, cfg["weights"]), device=device)
        with np.load(os.path.join(root, cfg["tables"])) as z:
            self.cdfs = np.ascontiguousarray(z["cdfs"], np.int32)

    @staticmethod
    def inputs(bank):
        """The bank as the encoder takes it: uint8 wire images."""
        return bank

    def encoder(self, depth: int):
        return self._pipeline.PipelinedEncoder(self.net, self.cdfs,
                                               depth=depth)

    def decoder(self, depth: int):
        return self._pipeline.PipelinedDecoder(self.net, self.cdfs,
                                               depth=depth)

    @staticmethod
    def decoded(result):
        """A decoder result -> (x_hat, y_hat or None)."""
        return result, None

    def transform(self, direction: str, x):
        """A call of the direction's transform alone on the batch x."""
        if direction == "encode":
            return lambda: self.net.analysis(x)
        z = self.net.analysis(x)
        return lambda: self.net.synthesis(z)

    sigma_of = None
