"""The (mean-)scale-hyperprior autoencoders (Balle 2018, Minnen 2018
without the context model) and the factorized-prior autoencoder (Balle
2017).

The port of the JAX package's ``models/hyperprior.py``: analysis g_a
(4x 5x5/s2 conv, GDN), synthesis g_s (4x 5x5/s2 transposed conv, IGDN),
hyper-analysis h_a, hyper-synthesis h_s (per-latent Gaussian scales, or
means and scales for the mean-scale model), and the factorized bottleneck
on z.  N = 128 internal and M = 192 latent channels at full width.

Modules run NCHW; the public methods of the two models take and give NHWC
as the JAX package does.  Parameter names follow flax's (``g_a.Conv_0``,
``g_s.ConvTranspose_3``, ``h_s.Conv_0``, ``bottleneck.H0``) so
``utils/weights_io.hyper_params_from_jax`` maps a checkpoint one to one.

Called as modules (``model(x, noise=...)``), the models give the JAX
package's training quantities: an NHWC batch in [0, 1] in, a dict of x_hat,
the quantized latents, the prior and the rates out, with uniform noise in
place of rounding (training) or a straight-through round.  Parameters
start as flax initialises them: lecun-normal kernels (a normal truncated at
2 sigma, variance 1/fan_in), zero biases, GDN's identity-like gamma, the
bottleneck's constant H and uniform b.  Models are built frozen;
``train.build_model`` makes one trainable, and the serving methods run
without gradients either way.

These float convolutions ran outside Pallas in the JAX package, so here they
are PyTorch's.  On the card they run with deterministic cuDNN algorithms and,
in float32, without TF32: the encoder and the decoder must derive
bitwise-equal scales (and means) from the same z_hat.

``dtype=torch.bfloat16`` is the serving fast path, as the JAX package's
``dtype=jnp.bfloat16``: parameters stay float32 (one checkpoint drives both
dtypes); each conv takes its input and weight in bf16 and returns bf16
(cuDNN and XLA accumulate in float32 and round the output), and its bias is
added after, in bf16, as flax adds it; GDN's channel mix stays float32
(``ops/gdn.py``); g_a, g_s and h_a return float32, and h_s's clip and exp
run in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..codec import entropy
from ..codec.entropy import FactorizedEntropy
from ..ops.gdn import GDN
from ..utils import weights_io
from ..utils.device import resolve_device


_TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated to [-2, 2]


@torch.no_grad()
def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: N(0, s^2) truncated to [-2s, 2s], s chosen
    so the variance is 1/fan_in.  Drawn on the CPU from ``generator`` (or
    the global one), so a seed gives the same values on any device; by
    rejection, redrawing the values past 2 sigma (torch's inverse-CDF
    sampler takes ~0.2 s a full-width layer on the CPU)."""
    draw = torch.randn(w.numel(), generator=generator)
    out = torch.nonzero(draw.abs() > 2.0).squeeze(1)
    while out.numel():
        again = torch.randn(out.numel(), generator=generator)
        draw[out] = again
        out = out[again.abs() > 2.0]
    w.copy_(draw.reshape(w.shape) * ((1.0 / fan_in) ** 0.5 / _TRUNC_STD))


def _add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax's ``y += bias`` after a conv in bf16: a second rounding."""
    return y + bias.to(y.dtype)[:, None, None]


class _FlaxInit:
    """flax's init of ``Conv`` and ``ConvTranspose``: a lecun-normal kernel
    over a fan-in of k * k * in_features, a zero bias."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        k = self.kernel_size
        _lecun_normal_(self.weight, self.in_channels * k[0] * k[1],
                       generator)
        nn.init.zeros_(self.bias)


class _Conv(_FlaxInit, nn.Conv2d):
    """A conv in its input's dtype.  In bf16, as flax: the conv of the
    bf16 input and weight rounded to bf16, then the bias added in bf16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.padding)

    def conv(self, x: torch.Tensor, padding) -> torch.Tensor:
        """The layer with ``padding`` (rows, columns) in place of its own
        (a tile that carries its halo rows takes 0 on X)."""
        if x.dtype == torch.float32:
            return F.conv2d(x, self.weight, self.bias, self.stride, padding)
        return _add_bias(F.conv2d(x, self.weight.to(x.dtype), None,
                                  self.stride, padding), self.bias)


def _whole(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv layer on the whole image: the transforms' default ``conv``
    (``parallel/hyper_sharded.py`` passes each layer on an X tile)."""
    return layer(x)


def _conv(cin: int, cout: int, k: int = 5, s: int = 2) -> _Conv:
    return _Conv(cin, cout, k, stride=s, padding=k // 2)


class _Deconv(_FlaxInit, nn.ConvTranspose2d):
    """flax ``ConvTranspose(k=5, s=2, padding="SAME")``: the 2x-dilated
    input padded by (3, 2), output exactly 2x.  PyTorch's padding is
    symmetric, so pad by 3 (padding=1) and drop the last row and column.
    Runs in its input's dtype, as ``_Conv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 5, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return super().forward(x)[..., :-1, :-1]
        return _add_bias(F.conv_transpose2d(
            x, self.weight.to(x.dtype), None, self.stride,
            self.padding)[..., :-1, :-1], self.bias)


class AnalysisTransform(nn.Module):
    """g_a: image (B, 3, X, Y) -> latent y (B, M, X/16, Y/16), float32."""

    def __init__(self, n: int = 128, m: int = 192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, (cin, cout) in enumerate(((3, n), (n, n), (n, n), (n, m))):
            setattr(self, f"Conv_{i}", _conv(cin, cout))
            if i < 3:
                setattr(self, f"GDN_{i}", GDN(cout))

    def forward(self, x: torch.Tensor, conv=_whole) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(3):
            x = getattr(self, f"GDN_{i}")(conv(getattr(self, f"Conv_{i}"), x))
        return conv(self.Conv_3, x).float()


class SynthesisTransform(nn.Module):
    """g_s: latent (B, M, zx, zy) -> image (B, 3, 16 zx, 16 zy), float32."""

    def __init__(self, n: int = 128, m: int = 192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, (cin, cout) in enumerate(((m, n), (n, n), (n, n), (n, 3))):
            setattr(self, f"ConvTranspose_{i}", _Deconv(cin, cout))
            if i < 3:
                setattr(self, f"GDN_{i}", GDN(cout, inverse=True))

    def forward(self, y: torch.Tensor, conv=_whole) -> torch.Tensor:
        y = y.to(self.dtype)
        for i in range(3):
            y = getattr(self, f"GDN_{i}")(
                conv(getattr(self, f"ConvTranspose_{i}"), y))
        return conv(self.ConvTranspose_3, y).float()


class HyperAnalysis(nn.Module):
    """h_a: |y| -> hyper-latent z (a 3x3/s1 conv, then 2x 5x5/s2),
    float32."""

    def __init__(self, n: int = 128, m: int = 192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = _conv(m, n, k=3, s=1)
        self.Conv_1 = _conv(n, n)
        self.Conv_2 = _conv(n, n)

    def forward(self, y: torch.Tensor, conv=_whole) -> torch.Tensor:
        h = F.relu(conv(self.Conv_0, torch.abs(y).to(self.dtype)))
        h = F.relu(conv(self.Conv_1, h))
        return conv(self.Conv_2, h).float()


class HyperSynthesis(nn.Module):
    """h_s: z_hat -> per-latent Gaussian scales sigma (positive, float32).
    Its last conv has ``outputs`` = M channels."""

    outputs = 1

    def __init__(self, n: int = 128, m: int = 192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ConvTranspose_0 = _Deconv(n, n)
        self.ConvTranspose_1 = _Deconv(n, n)
        self.Conv_0 = _conv(n, self.outputs * m, k=3, s=1)

    def _last(self, z: torch.Tensor, conv=_whole) -> torch.Tensor:
        h = F.relu(conv(self.ConvTranspose_0, z.to(self.dtype)))
        h = F.relu(conv(self.ConvTranspose_1, h))
        return conv(self.Conv_0, h).float()

    def forward(self, z: torch.Tensor, conv=_whole) -> torch.Tensor:
        return torch.exp(torch.clamp(self._last(z, conv), -10.0, 10.0))


class HyperSynthesisMeanScale(HyperSynthesis):
    """h_s of the mean-scale model: its last conv has 2M channels, the
    first M the means mu (``jnp.split`` on the channel axis), the other M
    log-scales."""

    outputs = 2

    def forward(self, z: torch.Tensor, conv=_whole
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        mu, log_sigma = torch.chunk(self._last(z, conv), 2, dim=1)
        return mu, torch.exp(torch.clamp(log_sigma, -10.0, 10.0))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW with the row-major strides of its shape.  ``contiguous``
    keeps the strides of size-1 dims, so a 1x1 z_hat decoded from a stream
    and the encoder's would reach the convs in two layouts, which oneDNN
    (and cuDNN) may sum in two orders: mu and sigma would differ by ulps
    between the two ends."""
    return x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _exact_float():
    """Full float32 and deterministic cuDNN algorithms (no-op on CPU)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _ceil_half(s: int, times: int) -> int:
    """A side after ``times`` stride-2 convs of pad k // 2."""
    for _ in range(times):
        s = -(-s // 2)
    return s


def _nhwc_view(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class _Autoencoder(nn.Module):
    """What every model shares: its device, flax's initialisation and the
    training noise of its quantized latents (``latents``, in draw order)."""

    latents = ("y",)

    @property
    def device(self) -> torch.device:
        return self.bottleneck.H0.device

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initialisation of every layer, drawn on the CPU from
        ``generator`` (or the global generator)."""
        for mod in self.modules():
            if isinstance(mod, (_FlaxInit, FactorizedEntropy)):
                mod.reset_parameters(generator)
            elif isinstance(mod, GDN):
                mod.reset_parameters()

    def latent_shapes(self, x_shape) -> Dict[str, Tuple[int, ...]]:
        """NCHW shapes of the quantized latents of an NHWC input."""
        b, h, w, _ = x_shape
        shapes = {"y": (b, self.m, _ceil_half(h, 4), _ceil_half(w, 4))}
        if "z" in self.latents:
            shapes["z"] = (b, self.n, _ceil_half(h, 6), _ceil_half(w, 6))
        return shapes

    def noise_like(self, x_shape, generator: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
        """U(-1/2, 1/2) for each latent of an NHWC input of ``x_shape``,
        drawn in order from ``generator`` on the model's device."""
        return {k: entropy.uniform_noise(s, generator, self.device)
                for k, s in self.latent_shapes(x_shape).items()}

    def _noise(self, x: torch.Tensor, noise, generator):
        if noise is None and generator is not None:
            noise = self.noise_like(x.shape, generator)
        return noise

    @staticmethod
    def _quantize(v: torch.Tensor, noise, name: str) -> torch.Tensor:
        if noise is None:
            return entropy.quantize_ste(v)
        return entropy.quantize_noise(v, noise[name])


class FactorizedPrior(_Autoencoder):
    """g_a/g_s + a factorized entropy bottleneck on y (Balle 2017 style);
    a training model only (no codec serves it)."""

    def __init__(self, n: int = 128, m: int = 192, device=None):
        super().__init__()
        self.n, self.m = n, m
        self.g_a = AnalysisTransform(n, m)
        self.g_s = SynthesisTransform(n, m)
        self.bottleneck = FactorizedEntropy(m)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                conv=_whole) -> Dict[str, torch.Tensor]:
        """x (B, X, Y, 3) NHWC in [0, 1] -> the JAX package's training
        quantities (NHWC): y quantized by ``noise`` (or noise drawn from
        ``generator``), else rounded straight through.  ``conv(layer, h)``
        runs each conv layer (``_whole``; ``train_loop --sp`` passes a
        rank's X tile)."""
        noise = self._noise(x, noise, generator)
        y_hat = self._quantize(self.g_a(_nchw(x), conv), noise, "y")
        bits_y = self.bottleneck(_nhwc_view(y_hat))
        x_hat = self.g_s(y_hat, conv)
        num_pixels = x.shape[0] * x.shape[1] * x.shape[2]   # B X Y (NHWC)
        return {"x_hat": _nhwc_view(x_hat), "y_hat": _nhwc_view(y_hat),
                "bits": bits_y, "bpp": bits_y / num_pixels}


class _Hyperprior(_Autoencoder):
    """What both hyperpriors share: g_a, g_s, h_a, the bottleneck, and an
    h_s of the subclass's ``hyper_synthesis``.

    Built on ``device`` (default: the card; ``device="cpu"`` to run on the
    host), in ``dtype`` (float32, or bfloat16 for the serving fast path).
    Inputs of the serving methods are moved to the module's device."""

    hyper_synthesis = HyperSynthesis
    latents = ("y", "z")

    def __init__(self, n: int = 128, m: int = 192, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: float32 or bfloat16")
        self.n, self.m, self.dtype = n, m, dtype
        self.g_a = AnalysisTransform(n, m, dtype)
        self.g_s = SynthesisTransform(n, m, dtype)
        self.h_a = HyperAnalysis(n, m, dtype)
        self.h_s = self.hyper_synthesis(n, m, dtype)
        self.bottleneck = FactorizedEntropy(n)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    @classmethod
    def from_checkpoint(cls, path: str, device=None,
                        dtype: torch.dtype = torch.float32):
        """Load the JAX package's ``hp_scale_*.params.msgpack`` (or, for
        ``MeanScaleHyperprior``, ``hp_meanscale_*``).  The format carries
        no model name: a checkpoint of the other family, told apart by its
        h_s's last conv (M outputs or 2M), raises ValueError."""
        state = weights_io.hyper_params_from_jax(
            weights_io.load_hyper_checkpoint(path))
        m = state["g_a.Conv_3.weight"].shape[0]
        got = state["h_s.Conv_0.weight"].shape[0]
        if got != cls.hyper_synthesis.outputs * m:
            raise ValueError(
                f"{path}: h_s ends in {got} channels for M = {m}, not "
                f"{cls.hyper_synthesis.outputs * m}: not a {cls.__name__} "
                f"checkpoint")
        model = cls(n=state["h_a.Conv_2.weight"].shape[0], m=m,
                    device=device, dtype=dtype)
        model.load_state_dict(state)
        return model

    def _training_out(self, x: torch.Tensor, y_hat: torch.Tensor,
                      z_hat: torch.Tensor, bits_y: torch.Tensor, conv,
                      **prior: torch.Tensor) -> Dict[str, torch.Tensor]:
        bits_z = self.bottleneck(_nhwc_view(z_hat))
        x_hat = self.g_s(y_hat, conv)
        num_pixels = x.shape[0] * x.shape[1] * x.shape[2]   # B X Y (NHWC)
        bits = bits_y + bits_z
        return {"x_hat": _nhwc_view(x_hat), "y_hat": _nhwc_view(y_hat),
                "z_hat": _nhwc_view(z_hat),
                **{k: _nhwc_view(v) for k, v in prior.items()},
                "bits_y": bits_y, "bits_z": bits_z, "bits": bits,
                "bpp": bits / num_pixels}

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(x.to(device=self.device, dtype=torch.float32))

    @torch.no_grad()
    def analysis_arrays(self, x: torch.Tensor, conv=_whole
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, X, Y, 3) in [0, 1] -> (unrounded y (B, X/16, Y/16, M),
        rounded z_hat (B, X/64, Y/64, N)), NHWC float32.  ``conv(layer,
        h)`` runs each conv layer (``_whole``: on the whole image)."""
        with _exact_float():
            y = self.g_a(self._in(x), conv)
            z_hat = torch.round(self.h_a(y, conv))
        return _nhwc(y), _nhwc(z_hat)

    @torch.no_grad()
    def decode_arrays(self, y_hat: torch.Tensor, conv=_whole
                      ) -> torch.Tensor:
        """y_hat (B, yx, yy, M) -> x_hat (B, 16 yx, 16 yy, 3), NHWC
        float32; ``conv`` as in ``analysis_arrays``."""
        with _exact_float():
            return _nhwc(self.g_s(self._in(y_hat), conv))


class ScaleHyperprior(_Hyperprior):
    """g_a/g_s + hyperprior entropy stage: h_s predicts the scales sigma."""

    def forward(self, x: torch.Tensor,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                conv=_whole) -> Dict[str, torch.Tensor]:
        """x (B, X, Y, 3) NHWC in [0, 1] -> the JAX package's training
        quantities (x_hat, y_hat, z_hat, sigma NHWC; bits_y, bits_z, bits,
        bpp): y and z plus ``noise`` (or noise drawn from ``generator``),
        else rounded straight through.  ``conv`` as in
        ``FactorizedPrior.forward``."""
        noise = self._noise(x, noise, generator)
        y = self.g_a(_nchw(x), conv)
        z = self.h_a(y, conv)
        y_hat = self._quantize(y, noise, "y")
        z_hat = self._quantize(z, noise, "z")
        sigma = self.h_s(z_hat, conv)
        bits_y = entropy.GaussianConditional.bits(y_hat, sigma)
        return self._training_out(x, y_hat, z_hat, bits_y, conv,
                                  sigma=sigma)

    @torch.no_grad()
    def scales_from_z(self, z_hat: torch.Tensor) -> torch.Tensor:
        """z_hat (B, zx, zy, N) -> sigma (B, 4 zx, 4 zy, M), NHWC."""
        with _exact_float():
            return _nhwc(self.h_s(self._in(z_hat)))


class MeanScaleHyperprior(_Hyperprior):
    """The mean-scale hyperprior: h_s predicts (mu, sigma), and the codec
    codes round(y - mu), zero-mean symbols, adding mu back before g_s."""

    hyper_synthesis = HyperSynthesisMeanScale

    def forward(self, x: torch.Tensor,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                conv=_whole) -> Dict[str, torch.Tensor]:
        """As ``ScaleHyperprior.forward``, with mu: the noise is added to y
        itself; without noise y is rounded about mu, round(y - mu) + mu."""
        noise = self._noise(x, noise, generator)
        y = self.g_a(_nchw(x), conv)
        z_hat = self._quantize(self.h_a(y, conv), noise, "z")
        mu, sigma = self.h_s(z_hat, conv)
        if noise is None:
            y_hat = entropy.quantize_ste(y - mu) + mu
        else:
            y_hat = entropy.quantize_noise(y, noise["y"])
        bits_y = entropy.GaussianConditional.bits(y_hat, sigma, mu)
        return self._training_out(x, y_hat, z_hat, bits_y, conv, mu=mu,
                                  sigma=sigma)

    @torch.no_grad()
    def params_from_z(self, z_hat: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z_hat (B, zx, zy, N) -> (mu, sigma), each (B, 4 zx, 4 zy, M)
        NHWC float32."""
        with _exact_float():
            mu, sigma = self.h_s(self._in(z_hat))
        return _nhwc(mu), _nhwc(sigma)
