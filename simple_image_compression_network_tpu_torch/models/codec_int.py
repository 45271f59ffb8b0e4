"""The 8-layer integer autoencoder (``eight_layers_net``) in PyTorch.

The counterpart of the JAX package's ``models/codec_int.py``: four strided
5x5/s2/p2 int8 convs (analysis, 768x512x3 -> 48x32x192 latent) and four
5x5/s2 transposed convs (synthesis), under the reference's integer contract.

The functional forms take the JAX package's parameter dictionary
({"w0".."w7": int8 [O,kx,ky,I], "b0".."b7": int8 [O]}, as tensors) and a
per-layer plan; ``IntCodecNet`` is the serving module, holding the default
plan's rewritten 3x3 weights as buffers.  On the card every layer of the
default plan runs on kernel A (``ops/cuda_conv.py``); the JAX package's
Pallas plans run on kernel A ("pallas"/"pd2s", "pallas2"/"pd2s2") or on the
block-sparse kernel F ("pallas3"/"pd2s3"), and its other mappings on A
("s4d") or F ("gemm", "tapn" as one-tap products; "phased", one launch
per output phase); "laxf32" is one float32 cuDNN conv (layer 0 only).  Every
plan's results are bit-identical to the direct forms ("lax", "dilated"),
the goldens.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, REFERENCE_NET
from ..ops import conv_fast, conv_int, cuda_conv
from ..utils import weights_io
from ..utils.device import resolve_device

_CONV_IMPL = {
    "lax": conv_int.conv2d_int8,          # direct 5x5/s2 golden
    "laxf32": conv_int.conv2d_int8_f32,   # float32 cuDNN, no TF32 (L0 only)
    "s2d": conv_fast.conv2d_int8_s2d,     # space-to-depth + kernel A
    "s4d": conv_fast.conv2d_int8_s4d,     # 4x4 space-to-depth + kernel A
    "gemm": conv_fast.conv2d_int8_gemm,   # im2col GEMM, kernel F one tap
    "pallas": cuda_conv.conv2d_int8_pallas,     # kernel A (TPU lane layout)
    "pallas2": cuda_conv.conv2d_int8_pallas2,   # kernel A (TPU flat layout)
    "pallas3": cuda_conv.conv2d_int8_pallas3,   # kernel F, 25 real taps
}
_DECONV_IMPL = {
    "dilated": conv_int.deconv2d_int8,    # lhs-dilated golden
    "phased": conv_int.deconv2d_int8_phased,    # kernel F, a launch a phase
    "d2s": conv_fast.deconv2d_int8_d2s,   # kernel A (4 phases) + d2s
    "tapn": conv_fast.deconv2d_int8_tapn,       # kernel F one tap, N = 36O
    "pd2s": cuda_conv.deconv2d_int8_pallas,
    "pd2s2": cuda_conv.deconv2d_int8_pallas2,
    "pd2s3": cuda_conv.deconv2d_int8_pallas3,   # kernel F, 9/6/6/4 taps
}

# The port's schedule: every layer through kernel A.  "tailfused" marks
# the last two deconvs, fused in the phase domain.
DEFAULT_PLAN = ("s2d",) * 4 + ("d2s", "d2s", "tailfused", "tailfused")
GOLDEN_PLAN = ("lax",) * 4 + ("dilated",) * 4


def _plan(impl, cfg: ModelConfig):
    plan = DEFAULT_PLAN if impl is None else tuple(impl)
    if len(plan) != len(cfg.layers):
        raise ValueError(f"plan has {len(plan)} entries for "
                         f"{len(cfg.layers)} layers")
    n_analysis = len(cfg.analysis)
    for i, name in enumerate(plan):
        known = (_CONV_IMPL if i < n_analysis
                 else {**_DECONV_IMPL, "tailfused": None})
        if name not in known:
            raise ValueError(f"unknown plan entry {name!r} for layer {i}")
    return plan


def analysis_int8(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig = REFERENCE_NET, *,
                  impl=None) -> torch.Tensor:
    """Analysis transform: x uint8/int8 (B, X, Y, 3) -> int8 latent
    (B, X/16, Y/16, 192), values 0..127."""
    plan = _plan(impl, cfg)
    h = conv_int.to_wire_int8(x)
    for i, _ in enumerate(cfg.analysis):
        h = _CONV_IMPL[plan[i]](h, params[f"w{i}"], params[f"b{i}"])
    return h


def synthesis_int8(params: Dict[str, torch.Tensor], z: torch.Tensor,
                   cfg: ModelConfig = REFERENCE_NET, *,
                   impl=None) -> torch.Tensor:
    """Synthesis transform: int8 latent -> int8 reconstruction."""
    plan = _plan(impl, cfg)
    h = z.to(torch.int8)
    n_analysis = len(cfg.analysis)
    j = 0
    while j < len(cfg.synthesis):
        i = n_analysis + j
        if plan[i] == "tailfused":
            if j + 1 >= len(cfg.synthesis) or plan[i + 1] != "tailfused":
                raise ValueError("tailfused must mark an adjacent deconv pair")
            h = conv_fast.deconv2d_int8_tail_fused(
                h, params[f"w{i}"], params[f"b{i}"],
                params[f"w{i + 1}"], params[f"b{i + 1}"])
            j += 2
        else:
            h = _DECONV_IMPL[plan[i]](h, params[f"w{i}"], params[f"b{i}"])
            j += 1
    return h


def eight_layers_net(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: ModelConfig = REFERENCE_NET, *,
                     phased: bool = True, impl=None) -> torch.Tensor:
    """Full forward: analysis then synthesis.  ``impl``: None (the default
    plan) or a per-layer tuple of plan names; ``phased=False`` with
    ``impl=None`` runs the golden plan, as in the JAX package."""
    if impl is None and not phased:
        impl = GOLDEN_PLAN
    z = analysis_int8(params, x, cfg, impl=impl)
    return synthesis_int8(params, z, cfg, impl=impl)


def random_params(cfg: ModelConfig = REFERENCE_NET, seed: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """Random int4 weights / int8 biases with the reference's shapes, as
    CPU tensors: the JAX package's ``random_params`` integers for the same
    seed (numpy's generator, drawn in the same order)."""
    rng = np.random.default_rng(seed)
    params: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(cfg.layers):
        params[f"w{i}"] = torch.from_numpy(rng.integers(
            -8, 8, size=layer.weight_shape, dtype=np.int8))
        params[f"b{i}"] = torch.from_numpy(rng.integers(
            -128, 128, size=(layer.out_ch,), dtype=np.int8))
    return params


class IntCodecNet(nn.Module):
    """The net under ``DEFAULT_PLAN`` with its 3x3 weights rewritten once.

    Buffers ``w3_i`` (3, 3, C, N) int8 HWIO and ``b_i`` (N,) int8 hold layer
    i's kernel-A weights and phase-tiled bias: s2d for layers 0-3, d2s for
    4-6, s2dtail for 7 (consuming layer 6's phase form); ``wp_i`` holds
    them packed for the kernel (``cuda_conv.pack_conv3x3``, not saved in
    the state dict), so that serving packs nothing per call.  Fully
    convolutional: any input whose sides are multiples of 16 works."""

    def __init__(self, params: Dict[str, torch.Tensor], device=None):
        super().__init__()
        dev = resolve_device(device)
        p = {k: torch.as_tensor(v) for k, v in params.items()}
        for i in range(4):
            self._add(i, conv_fast.conv_weights_s2d(p[f"w{i}"]),
                      p[f"b{i}"], dev)
        for i in (4, 5, 6):
            self._add(i, conv_fast.deconv_weights_d2s(p[f"w{i}"]),
                      conv_fast.tile_bias(p[f"b{i}"], 4), dev)
        self._add(7, conv_fast.deconv_weights_s2dtail(p["w7"]),
                  conv_fast.tile_bias(p["b7"], 16), dev)

    def _add(self, i: int, w3: torch.Tensor, bias: torch.Tensor, dev):
        self.register_buffer(f"w3_{i}", w3.contiguous().to(dev))
        self.register_buffer(f"wp_{i}", cuda_conv.pack_conv3x3(
            getattr(self, f"w3_{i}")), persistent=False)
        self.register_buffer(f"b_{i}", bias.to(torch.int8).contiguous()
                             .to(dev))

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> "IntCodecNet":
        """Load the JAX package's ``reference_weights.npz``."""
        return cls(weights_io.params_from_jax(
            weights_io.load_checkpoint(path)), device=device)

    @property
    def device(self) -> torch.device:
        return self.w3_0.device

    def _layer(self, i: int, h: torch.Tensor,
               valid: bool = False) -> torch.Tensor:
        """Layer i's 3x3 conv on kernel A: SAME, or VALID on both axes
        (``valid``: the input carries the 1-pixel halo, as the sharded net
        gives it)."""
        return cuda_conv._conv3x3(h, getattr(self, f"w3_{i}"),
                                  getattr(self, f"b_{i}"), True, valid,
                                  valid, getattr(self, f"wp_{i}"))

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """uint8/int8 (B, X, Y, 3) -> int8 latent (B, X/16, Y/16, 192)."""
        h = conv_int.to_wire_int8(x.to(self.device))
        for i in range(4):
            h = self._layer(i, conv_fast.space_to_depth(h).contiguous())
        return h

    def synthesis(self, z: torch.Tensor) -> torch.Tensor:
        """int8 latent -> int8 (B, 16*zx, 16*zy, 3) reconstruction."""
        h = z.to(device=self.device, dtype=torch.int8).contiguous()
        for i in (4, 5):
            h = conv_fast.depth_to_space(self._layer(i, h)).contiguous()
        return conv_fast.depth_to_space4(self._layer(7, self._layer(6, h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.synthesis(self.analysis(x))
