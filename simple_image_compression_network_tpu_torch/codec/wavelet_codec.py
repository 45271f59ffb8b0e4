"""The wavelet integer codec: uint8 images <-> ``CODEC_INT8`` containers
over one ``intnet_haar`` profile.

The counterpart of the JAX package's ``codec/wavelet_codec.py``:

  encode:  uint8 RGB -> wire map (RGB >> 2 or YCoCg quantization, on the
           device) -> bit-exact integer analysis (kernel A) + rANS with the
           profile's static CDFs (``codec/int_codec.py``)
  decode:  container -> integer synthesis (kernel A) -> display map
           (dequantize, inverse colour transform, border compensation, on
           the device) -> uint8 RGB

A profile is (Haar weights, CDF table, wire map); its containers are plain
``CODEC_INT8`` bitstreams, byte-identical with the JAX package's.  The wire
and display maps are elementwise PyTorch ops in float32, as the JAX
package's jitted maps are, and equal its numpy maps (``intnet_haar``)
uint8 for uint8.

Profiles (the JAX package's, measured there on its 4-frame eval set,
docs/RESULTS.md; quality figures of the construction, not of this port):

  name          wire    det2                 eval bpp / PSNR
  haar-rgb      rgb     all 9                2.97 / 28.7 dB
  haar          ycocg   all 9                2.06 / 28.7 dB
  haar422       ycocg   7 (no diag chroma)   1.84 / 28.2 dB   <- default
  haar420       ycocg   3 (luma)             1.44 / 27.6 dB
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import intnet_haar
from ..config import reference_net_for_input
from ..models import codec_int
from ..utils import weights_io
from ..utils.device import resolve_device
from . import int_codec

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROFILES = {
    "haar-rgb": dict(wire="rgb", det2_keep=None, cdfs="haar_cdfs.npz"),
    "haar": dict(wire="ycocg", det2_keep=None, cdfs="haar_ycocg_cdfs.npz"),
    "haar422": dict(wire="ycocg", det2_keep=(0, 1, 2, 3, 4, 6, 7),
                    cdfs="haar_ycocg422_cdfs.npz"),
    "haar420": dict(wire="ycocg", det2_keep=(0, 1, 2),
                    cdfs="haar_ycocg420_cdfs.npz"),
}
DEFAULT_PROFILE = "haar422"


def wire_ycocg(rgb: torch.Tensor) -> torch.Tensor:
    """float32 mirror of ``intnet_haar.to_wire_ycocg`` (integer-valued
    float32 in and out)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    w0 = torch.floor(torch.floor(0.25 * r + 0.5 * g + 0.25 * b) / 4.0)
    w1 = torch.floor((r - b + 256.0) / 8.0)
    w2 = torch.floor((torch.floor(g - 0.5 * (r + b)) + 256.0) / 8.0)
    return torch.clamp(torch.stack([w0, w1, w2], dim=-1), 0.0, 63.0)


def display_ycocg(y_out: torch.Tensor, out_scale: float = 2.0
                  ) -> torch.Tensor:
    """float32 mirror of ``intnet_haar.display_ycocg`` without the border
    compensation and the uint8 rounding."""
    yv = y_out / out_scale
    lum = 4.0 * yv[..., 0] + 1.5
    co = 8.0 * yv[..., 1] - 256.0 + 3.5
    cg = 8.0 * yv[..., 2] - 256.0 + 3.5
    tmp = lum - 0.5 * cg
    return torch.stack([tmp + 0.5 * co, lum + 0.5 * cg, tmp - 0.5 * co],
                       dim=-1)


def wire_map(images_u8: torch.Tensor, wire: str) -> torch.Tensor:
    """(B, X, Y, 3) uint8 -> int8 wire images, on the images' device:
    equal to ``intnet_haar.to_wire`` / ``to_wire_ycocg``."""
    xf = images_u8.to(torch.float32)
    if wire == "ycocg":
        return wire_ycocg(xf).to(torch.int8)
    return torch.floor(xf / 4.0).to(torch.int8)


def display_map(y: torch.Tensor, wire: str, disp_a: torch.Tensor,
                disp_b: torch.Tensor) -> torch.Tensor:
    """int8 net output (B, X, Y, 3) -> uint8 RGB, on its device: equal to
    ``intnet_haar.display`` / ``display_ycocg``.  The bilinear output
    layer's last row and column hold one-tap (half-value) sums: doubled
    here, the corner once."""
    yv = y.to(torch.float32, copy=True)
    yv[:, -1, :, :] *= 2.0
    yv[:, :, -1, :] *= 2.0
    yv[:, -1, -1, :] /= 2.0
    rgb = display_ycocg(yv) if wire == "ycocg" else disp_a * yv + disp_b
    return torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)


class WaveletCodec:
    """uint8-image codec over one ``intnet_haar`` profile, on ``device``
    (the card unless the caller asks for the CPU).

    Holds one ``IntCodecNet`` of the profile's weights (``params``, the
    ``haar_params`` dict layout with optional ``disp_a``/``disp_b``; by
    default the profile's construction) and its static CDFs (by default
    the shipped ``checkpoints/haar*_cdfs.npz``)."""

    def __init__(self, profile: str = DEFAULT_PROFILE,
                 params: Dict[str, np.ndarray] | None = None,
                 static_cdfs: np.ndarray | None = None, device=None):
        spec = PROFILES[profile]
        self.profile = profile
        self.wire = spec["wire"]
        self.device = dev = resolve_device(device)
        p = (params if params is not None
             else intnet_haar.haar_params(det2_keep=spec["det2_keep"]))
        self.disp_a = np.asarray(p.get("disp_a", intnet_haar.DISP_A / 2.0))
        self.disp_b = np.asarray(p.get("disp_b", intnet_haar.DISP_B))
        weights = weights_io.params_from_jax(
            {k: v for k, v in p.items() if not k.startswith("disp")})
        self.params = {k: v.to(dev) for k, v in weights.items()}
        self.net = codec_int.IntCodecNet(weights, device=dev)
        if static_cdfs is None:
            static_cdfs = weights_io.load_static_cdfs(
                os.path.join(_ROOT, "checkpoints", spec["cdfs"]))
        self.cdfs = static_cdfs
        self._disp = (torch.tensor(self.disp_a, dtype=torch.float32,
                                   device=dev),
                      torch.tensor(self.disp_b, dtype=torch.float32,
                                   device=dev))

    # -- wire and display maps: the host references (numpy) and the device
    #    maps the codec runs --------------------------------------------
    def to_wire(self, images_u8: np.ndarray) -> np.ndarray:
        if self.wire == "ycocg":
            return intnet_haar.to_wire_ycocg(images_u8)
        return intnet_haar.to_wire(images_u8)

    def display(self, y_out: np.ndarray) -> np.ndarray:
        if self.wire == "ycocg":
            return intnet_haar.display_ycocg(y_out)
        return intnet_haar.display(y_out, self.disp_a, self.disp_b)

    def _wire_dev(self, images_u8) -> torch.Tensor:
        return wire_map(torch.as_tensor(images_u8).to(self.device),
                        self.wire)

    def _display_dev(self, y_int8: torch.Tensor) -> torch.Tensor:
        return display_map(y_int8, self.wire, *self._disp)

    # -- container API ----------------------------------------------------
    def compress_batch(self, images_u8) -> List[bytes]:
        """(B, X, Y, 3) uint8 (numpy or tensor) -> B ``CODEC_INT8``
        containers, on the "auto" coder."""
        return int_codec.compress_batch(self.net, self._wire_dev(images_u8),
                                        static_cdfs=self.cdfs, coder="auto")

    def decompress_batch(self, blobs: Sequence[bytes]
                         ) -> Tuple[np.ndarray, torch.Tensor]:
        """containers -> ((B, X, Y, 3) uint8 reconstruction on the host,
        the int8 net output on the device)."""
        rec, x_hat = self.decompress_batch_device(blobs)
        return rec.cpu().numpy(), x_hat

    def decompress_batch_device(self, blobs: Sequence[bytes]
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Like ``decompress_batch``, with the uint8 reconstruction left on
        the device."""
        x_hat, _ = int_codec.decompress_batch(self.net, blobs,
                                              static_cdfs=self.cdfs,
                                              coder="auto")
        return self._display_dev(x_hat), x_hat

    def roundtrip_metrics(self, images_u8: np.ndarray) -> Dict[str, float]:
        """bpp, PSNR and bit-exactness of a uint8 batch's round trip; the
        direct result comes from the golden plan (float64 convolutions,
        independent of kernel A)."""
        blobs = self.compress_batch(images_u8)
        rec, x_hat = self.decompress_batch(blobs)
        cfg = reference_net_for_input(images_u8.shape[1],
                                      images_u8.shape[2])
        direct = codec_int.eight_layers_net(
            self.params, torch.from_numpy(self.to_wire(images_u8)).to(
                self.device), cfg, impl=codec_int.GOLDEN_PLAN)
        exact = bool(torch.equal(x_hat, direct))
        mse = float(np.mean((rec.astype(np.float64)
                             - images_u8.astype(np.float64)) ** 2))
        n_bytes = sum(len(s) for s in blobs)
        n_px = images_u8.shape[0] * images_u8.shape[1] * images_u8.shape[2]
        return {
            "bpp": round(8.0 * n_bytes / n_px, 3),
            "psnr_db": round(10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12)),
                             2),
            "decode_bit_exact": exact,
        }
