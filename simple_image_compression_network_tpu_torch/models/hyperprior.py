"""The scale-hyperprior autoencoder (Balle 2018 style), forward only.

The port of the JAX package's ``models/hyperprior.py``: analysis g_a
(4x 5x5/s2 conv, GDN), synthesis g_s (4x 5x5/s2 transposed conv, IGDN),
hyper-analysis h_a and hyper-synthesis h_s (per-latent Gaussian scales),
and the factorized bottleneck on z.  N = 128 internal and M = 192 latent
channels at full width.

Modules run NCHW; the public methods of ``ScaleHyperprior`` take and give
NHWC as the JAX package does.  Parameter names follow flax's
(``g_a.Conv_0``, ``g_s.ConvTranspose_3``, ``h_s.Conv_0``, ``bottleneck.H0``)
so ``utils/weights_io.hyper_params_from_jax`` maps a checkpoint one to one.

These float convolutions ran outside Pallas in the JAX package, so here they
are PyTorch's.  On the card they run in full float32 (no TF32) with
deterministic cuDNN algorithms: the encoder and the decoder must derive
bitwise-equal scales from the same z_hat.

``MeanScaleHyperprior`` is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..codec.entropy import FactorizedEntropy
from ..ops.gdn import GDN
from ..utils import weights_io
from ..utils.device import resolve_device


def _conv(cin: int, cout: int, k: int = 5, s: int = 2) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=s, padding=k // 2)


class _Deconv(nn.ConvTranspose2d):
    """flax ``ConvTranspose(k=5, s=2, padding="SAME")``: the 2x-dilated
    input padded by (3, 2), output exactly 2x.  PyTorch's padding is
    symmetric, so pad by 3 (padding=1) and drop the last row and column."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 5, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[..., :-1, :-1]


class AnalysisTransform(nn.Module):
    """g_a: image (B, 3, X, Y) -> latent y (B, M, X/16, Y/16)."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        for i, (cin, cout) in enumerate(((3, n), (n, n), (n, n), (n, m))):
            setattr(self, f"Conv_{i}", _conv(cin, cout))
            if i < 3:
                setattr(self, f"GDN_{i}", GDN(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"GDN_{i}")(getattr(self, f"Conv_{i}")(x))
        return self.Conv_3(x)


class SynthesisTransform(nn.Module):
    """g_s: latent (B, M, zx, zy) -> image (B, 3, 16 zx, 16 zy)."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        for i, (cin, cout) in enumerate(((m, n), (n, n), (n, n), (n, 3))):
            setattr(self, f"ConvTranspose_{i}", _Deconv(cin, cout))
            if i < 3:
                setattr(self, f"GDN_{i}", GDN(cout, inverse=True))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            y = getattr(self, f"GDN_{i}")(
                getattr(self, f"ConvTranspose_{i}")(y))
        return self.ConvTranspose_3(y)


class HyperAnalysis(nn.Module):
    """h_a: |y| -> hyper-latent z (a 3x3/s1 conv, then 2x 5x5/s2)."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        self.Conv_0 = _conv(m, n, k=3, s=1)
        self.Conv_1 = _conv(n, n)
        self.Conv_2 = _conv(n, n)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Conv_0(torch.abs(y)))
        h = F.relu(self.Conv_1(h))
        return self.Conv_2(h)


class HyperSynthesis(nn.Module):
    """h_s: z_hat -> per-latent Gaussian scales sigma (positive)."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        self.ConvTranspose_0 = _Deconv(n, n)
        self.ConvTranspose_1 = _Deconv(n, n)
        self.Conv_0 = _conv(n, m, k=3, s=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.ConvTranspose_0(z))
        h = F.relu(self.ConvTranspose_1(h))
        return torch.exp(torch.clamp(self.Conv_0(h), -10.0, 10.0))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _exact_float():
    """Full float32 and deterministic cuDNN algorithms (no-op on CPU)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class ScaleHyperprior(nn.Module):
    """g_a/g_s + hyperprior entropy stage; inference methods only.

    Built on ``device`` (default: the card; ``device="cpu"`` to run on the
    host).  Inputs are moved to the module's device."""

    def __init__(self, n: int = 128, m: int = 192, device=None):
        super().__init__()
        self.n, self.m = n, m
        self.g_a = AnalysisTransform(n, m)
        self.g_s = SynthesisTransform(n, m)
        self.h_a = HyperAnalysis(n, m)
        self.h_s = HyperSynthesis(n, m)
        self.bottleneck = FactorizedEntropy(n)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> "ScaleHyperprior":
        """Load the JAX package's ``hp_scale_*.params.msgpack``."""
        state = weights_io.hyper_params_from_jax(
            weights_io.load_hyper_checkpoint(path))
        model = cls(n=state["h_a.Conv_2.weight"].shape[0],
                    m=state["g_a.Conv_3.weight"].shape[0], device=device)
        model.load_state_dict(state)
        return model

    @property
    def device(self) -> torch.device:
        return self.bottleneck.H0.device

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(x.to(device=self.device, dtype=torch.float32))

    @torch.no_grad()
    def analysis_arrays(self, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, X, Y, 3) in [0, 1] -> (unrounded y (B, X/16, Y/16, M),
        rounded z_hat (B, X/64, Y/64, N)), NHWC float32."""
        with _exact_float():
            y = self.g_a(self._in(x))
            z_hat = torch.round(self.h_a(y))
        return _nhwc(y), _nhwc(z_hat)

    @torch.no_grad()
    def scales_from_z(self, z_hat: torch.Tensor) -> torch.Tensor:
        """z_hat (B, zx, zy, N) -> sigma (B, 4 zx, 4 zy, M), NHWC."""
        with _exact_float():
            return _nhwc(self.h_s(self._in(z_hat)))

    @torch.no_grad()
    def decode_arrays(self, y_hat: torch.Tensor) -> torch.Tensor:
        """y_hat (B, yx, yy, M) -> x_hat (B, 16 yx, 16 yy, 3), NHWC."""
        with _exact_float():
            return _nhwc(self.g_s(self._in(y_hat)))
