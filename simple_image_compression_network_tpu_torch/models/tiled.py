"""Overlap-tiled execution of the integer autoencoder.

The counterpart of the JAX package's ``models/tiled.py``: the image is
processed in X-tiles with a receptive-field margin and cropped, so peak
activation memory is O(tile_x * Y * C) whatever the image height.
Bit-exact by construction:

* analysis (4x conv k5/s2/p2): latent segment [a, b) depends on input
  [16a - 30, 16b + 30), so an input margin of 30 suffices;
* synthesis (4x deconv): each stage loses 1 border pixel at its own
  resolution, so a latent margin of 2 leaves the output tile exact; with the
  analysis margin that is 16*2 + 30 = 62 input pixels, rounded to 64.

At the image's own borders no margin is needed: the convs' zero padding is
the right boundary condition there.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import reference_net_for_input
from . import codec_int

MARGIN = 64          # input-pixel margin guaranteeing bit-exact interiors
LATENT_MARGIN = MARGIN // 16


def _tiles(xd: int, tile_x: int):
    """(t0, t1, e0, e1): each tile and its extent with the margins."""
    if tile_x <= 0 or tile_x % 16 or xd % 16:
        raise ValueError(f"tile_x ({tile_x}) and the image height ({xd}) "
                         f"must be positive multiples of 16")
    for t0 in range(0, xd, tile_x):
        t1 = min(t0 + tile_x, xd)
        yield t0, t1, max(t0 - MARGIN, 0), min(t1 + MARGIN, xd)


def eight_layers_net_tiled(params: Dict[str, torch.Tensor], x: torch.Tensor,
                           tile_x: int, impl=None) -> torch.Tensor:
    """The full net on X-tiles of ``tile_x`` rows (a multiple of 16) with
    margins; bit-identical to ``codec_int.eight_layers_net``."""
    yd = x.shape[2]
    outs = []
    for t0, t1, e0, e1 in _tiles(x.shape[1], tile_x):
        cfg = reference_net_for_input(e1 - e0, yd)
        seg = codec_int.eight_layers_net(params, x[:, e0:e1], cfg, impl=impl)
        outs.append(seg[:, t0 - e0:t1 - e0])
    return torch.cat(outs, dim=1)


def analysis_tiled(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   tile_x: int, impl=None) -> torch.Tensor:
    """Analysis only on X-tiles (the encode of a large image)."""
    yd = x.shape[2]
    outs = []
    for t0, t1, e0, e1 in _tiles(x.shape[1], tile_x):
        cfg = reference_net_for_input(e1 - e0, yd)
        z = codec_int.analysis_int8(params, x[:, e0:e1], cfg, impl=impl)
        z0 = (t0 - e0) // 16
        outs.append(z[:, z0:z0 + (t1 - t0) // 16])
    return torch.cat(outs, dim=1)
