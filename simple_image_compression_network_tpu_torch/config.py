"""Layer/model configuration (the port's own copy of the JAX package's
``config.py``, kept identical so both packages describe the same nets).

Mirrors the reference's compile-time layer table (``config_nonsquare.h:1-135``):
eight 5x5 stride-2 pad-2 layers — four strided convs (analysis) followed by four
transposed convs (synthesis).  The reference's folding factors (SIMD/PE/W_TILES)
are FPGA scheduling knobs with no TPU meaning; they are kept only so the weight
converter can decode the reference's packed parameter layout
(``weights.hpp:110-150``, ``memdata_nonsquare.h``).

Axis convention: the reference stores feature maps ``[image][x][y][channel]``
with ``IFM_ROW`` the x extent (768, Kodak long side) and ``IFM_COL`` the y
extent (512) — see ``conv3_nonsquare_tb.cpp:757`` / ``conv.hpp:105``.  We use
NHWC arrays of shape ``(N, X, Y, C)`` so H==x and W==y; convolution treats both
spatial dims identically, so this is purely a naming choice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """One conv / transposed-conv layer (one CONV_i block of config_nonsquare.h)."""

    name: str
    transposed: bool          # False: strided conv (analysis); True: deconv (synthesis)
    kernel: int               # CONV_i_K   (square 5x5)
    stride: int               # CONV_i_S
    padding: int              # CONV_i_P
    in_ch: int                # CONV_i_IFM_CH
    out_ch: int               # CONV_i_OFM_CH
    in_x: int                 # CONV_i_IFM_ROW
    in_y: int                 # CONV_i_IFM_COL
    out_x: int                # CONV_i_OFM_ROW
    out_y: int                # CONV_i_OFM_COL
    in_bits: int = 8          # CONV_i_IN_BIT (uint8 on the wire)
    out_bits: int = 8         # CONV_i_OUT_BIT (int8, non-negative post-ReLU)
    w_bits: int = 4           # CONV_i_W_BIT (int4 weights)
    # FPGA folding factors — only needed to decode the reference weight layout.
    simd: int = 0             # CONV_i_SIMD
    pe: int = 0               # CONV_i_PE
    w_tiles: int = 0          # CONV_i_W_TILES

    def __post_init__(self):
        k, s, p = self.kernel, self.stride, self.padding
        if self.transposed:
            # deconv522 output algebra: s*(in-1) - (2p-k) + (s-1)
            # (conv_nonsquare_top.cpp:94-95)
            expect_x = s * (self.in_x - 1) - (2 * p - k) + (s - 1)
            expect_y = s * (self.in_y - 1) - (2 * p - k) + (s - 1)
        else:
            expect_x = (self.in_x + 2 * p - k) // s + 1
            expect_y = (self.in_y + 2 * p - k) // s + 1
        assert (self.out_x, self.out_y) == (expect_x, expect_y), (
            f"{self.name}: output dims {(self.out_x, self.out_y)} != "
            f"expected {(expect_x, expect_y)}")

    @property
    def weight_shape(self) -> Tuple[int, int, int, int]:
        """Unpacked weight shape [O, kx, ky, I] (conv3_nonsquare_tb.cpp:539)."""
        return (self.out_ch, self.kernel, self.kernel, self.in_ch)

    @property
    def macs(self) -> int:
        return self.out_x * self.out_y * self.out_ch * self.kernel ** 2 * self.in_ch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The full 8-layer autoencoder (eight_layers_net, conv_nonsquare_top.cpp:295)."""

    layers: Tuple[LayerConfig, ...]

    @property
    def analysis(self) -> Tuple[LayerConfig, ...]:
        return tuple(l for l in self.layers if not l.transposed)

    @property
    def synthesis(self) -> Tuple[LayerConfig, ...]:
        return tuple(l for l in self.layers if l.transposed)

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        l = self.layers[0]
        return (l.in_x, l.in_y, l.in_ch)

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        l = self.analysis[-1]
        return (l.out_x, l.out_y, l.out_ch)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)


def _conv(i, transposed, cin, cout, ix, iy, simd, pe, tiles) -> LayerConfig:
    s = 2
    if transposed:
        ox, oy = 2 * ix, 2 * iy
    else:
        ox, oy = ix // 2, iy // 2
    return LayerConfig(
        name=f"conv_{i}", transposed=transposed, kernel=5, stride=s, padding=2,
        in_ch=cin, out_ch=cout, in_x=ix, in_y=iy, out_x=ox, out_y=oy,
        simd=simd, pe=pe, w_tiles=tiles)


# The reference network, verbatim from config_nonsquare.h:1-135.
REFERENCE_NET = ModelConfig(layers=(
    _conv(0, False, 3, 128, 768, 512, simd=3, pe=8, tiles=400),
    _conv(1, False, 128, 128, 384, 256, simd=8, pe=16, tiles=3200),
    _conv(2, False, 128, 128, 192, 128, simd=8, pe=16, tiles=3200),
    _conv(3, False, 128, 192, 96, 64, simd=8, pe=24, tiles=3200),
    _conv(4, True, 192, 128, 48, 32, simd=12, pe=16, tiles=3200),
    _conv(5, True, 128, 128, 96, 64, simd=8, pe=16, tiles=3200),
    _conv(6, True, 128, 128, 192, 128, simd=8, pe=16, tiles=3200),
    _conv(7, True, 128, 3, 384, 256, simd=8, pe=3, tiles=400),
))


def reference_net_for_input(in_x: int, in_y: int) -> ModelConfig:
    """The same 8-layer topology for an arbitrary input size divisible by 16.

    The reference hard-codes 768x512; the network itself is fully
    convolutional, so any multiple-of-16 input works (needed for spatial
    tiling of large images and for small test shapes).
    """
    if in_x % 16 or in_y % 16:
        raise ValueError(f"input dims must be divisible by 16, got {(in_x, in_y)}")
    chans = [(3, 128), (128, 128), (128, 128), (128, 192),
             (192, 128), (128, 128), (128, 128), (128, 3)]
    layers = []
    x, y = in_x, in_y
    ref = REFERENCE_NET.layers
    for i, (cin, cout) in enumerate(chans):
        t = i >= 4
        layers.append(_conv(i, t, cin, cout, x, y,
                            simd=ref[i].simd, pe=ref[i].pe, tiles=ref[i].w_tiles))
        x, y = (2 * x, 2 * y) if t else (x // 2, y // 2)
    return ModelConfig(layers=tuple(layers))
