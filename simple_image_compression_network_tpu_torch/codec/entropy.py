"""Entropy models, training quantizers and integer CDF tables.

The port's own copy of the JAX package's ``codec/entropy.py``:

* ``quantize_noise``: additive U(-1/2, 1/2) noise, the differentiable proxy
  for rounding in training; ``quantize_ste``: a hard round whose gradient
  is the identity.
* ``GaussianConditional``: discretized N(mu, sigma^2) likelihoods of the
  latent y given the hyperprior's scales (and means), and their rate.
* ``FactorizedEntropy``: the learned per-channel CDF of the hyper-latent z
  (or of y in the factorized prior); its probabilities build the z tables,
  and called on a tensor it gives the tensor's rate.
* ``quantize_cdf``, ``gaussian_cdf_table``, ``default_scale_table`` and
  ``scale_to_index``: the integer tables the rANS coder consumes, computed
  with numpy in float64 exactly as the JAX package computes them.

All rates are in bits.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gdn import lower_bound

SCALE_MIN = 0.11
LOG2 = 0.6931471805599453


def uniform_noise(shape, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """U(-1/2, 1/2) float32 of ``shape``, drawn from ``generator`` on
    ``device`` (the generator's own)."""
    return torch.rand(shape, generator=generator, device=device) - 0.5


def quantize_noise(y: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Additive uniform noise proxy for rounding (training); ``noise`` is
    ``uniform_noise`` of y's shape (JAX draws it from a key)."""
    return y + noise


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor) -> torch.Tensor:
        return torch.round(y)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def quantize_ste(y: torch.Tensor) -> torch.Tensor:
    """round(y) with the identity as its gradient (straight through)."""
    return _RoundSTE.apply(y)


def _std_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


class GaussianConditional:
    """Discretized conditional N(mu, sigma^2) over integer symbols."""

    @staticmethod
    def likelihood(y_hat: torch.Tensor, scale: torch.Tensor,
                   mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        """P(y_hat) = Phi((v+.5)/s) - Phi((v-.5)/s), v = y_hat - mean;
        the scale bounded below by SCALE_MIN with ``lower_bound``'s
        gradient."""
        scale = lower_bound(scale, SCALE_MIN)
        v = y_hat if mean is None else y_hat - mean
        upper = _std_cdf((v + 0.5) / scale)
        lower = _std_cdf((v - 0.5) / scale)
        return torch.clamp(upper - lower, min=1e-9)

    @staticmethod
    def bits(y_hat: torch.Tensor, scale: torch.Tensor,
             mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Total rate in bits."""
        p = GaussianConditional.likelihood(y_hat, scale, mean)
        return -torch.sum(torch.log(p)) / LOG2


class FactorizedEntropy(nn.Module):
    """Per-channel learned univariate CDF (entropy bottleneck).

    c(x) = sigmoid(f_K(...f_1(x))), f_k(x) = softplus(H_k) x + b_k + a_k
    tanh(softplus(H_k) x + b_k).  Parameters keep the JAX package's names
    and shapes: H{k} (C, d_{k+1}, d_k), b{k} and a{k} (C, d_{k+1}, 1), and
    its initialisation: H{k} constant, b{k} U(-1/2, 1/2), a{k} zeros."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3),
                 init_scale: float = 10.0):
        super().__init__()
        self.channels = channels
        dims = (1,) + tuple(filters) + (1,)
        self.n_layers = len(dims) - 1
        self.h_init = []
        scale = init_scale ** (1.0 / (len(filters) + 1))
        for k in range(self.n_layers):
            self.h_init.append(
                float(np.log(np.expm1(1.0 / scale / dims[k + 1]))))
            self.register_parameter(f"H{k}", nn.Parameter(
                torch.empty((channels, dims[k + 1], dims[k]))))
            self.register_parameter(f"b{k}", nn.Parameter(
                torch.empty((channels, dims[k + 1], 1))))
            if k < self.n_layers - 1:
                self.register_parameter(f"a{k}", nn.Parameter(
                    torch.empty((channels, dims[k + 1], 1))))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initialisation; ``generator`` (a CPU generator, or the
        global one) draws the b{k}, the same values on any device."""
        for k in range(self.n_layers):
            getattr(self, f"H{k}").fill_(self.h_init[k])
            b = getattr(self, f"b{k}")
            b.copy_(torch.rand(b.shape, generator=generator) - 0.5)
            if k < self.n_layers - 1:
                getattr(self, f"a{k}").zero_()

    def _logits_cdf(self, x: torch.Tensor) -> torch.Tensor:
        """x: (C, 1, n) samples per channel -> CDF logits, same shape."""
        for k in range(self.n_layers):
            h = F.softplus(getattr(self, f"H{k}"))
            x = torch.matmul(h, x) + getattr(self, f"b{k}")
            if k < self.n_layers - 1:
                x = x + torch.tanh(getattr(self, f"a{k}")) * torch.tanh(x)
        return x

    def likelihood(self, y_hat: torch.Tensor) -> torch.Tensor:
        """y_hat: (..., C) integer-valued floats -> P, same shape."""
        c = y_hat.shape[-1]
        flat = y_hat.reshape(-1, c).t()[:, None, :]          # (C, 1, n)
        lo = self._logits_cdf(flat - 0.5)
        hi = self._logits_cdf(flat + 0.5)
        sign = -torch.sign(lo + hi)     # numerically stable difference
        p = torch.abs(torch.sigmoid(sign * hi) - torch.sigmoid(sign * lo))
        p = p[:, 0, :].t().reshape(y_hat.shape)
        return torch.clamp(p, min=1e-9)

    def forward(self, y_hat: torch.Tensor) -> torch.Tensor:
        """Rate in bits of ``y_hat`` (..., C)."""
        return -torch.sum(torch.log(self.likelihood(y_hat))) / LOG2


# ---------------------------------------------------------------------------
# Integer CDF tables for range coding
# ---------------------------------------------------------------------------

CDF_PRECISION = 16  # probabilities quantized to 1/2^16


def quantize_cdf(pmf: np.ndarray, precision: int = CDF_PRECISION
                 ) -> np.ndarray:
    """PMF (float, sums <= 1 over symbols + overflow) -> int32 CDF of
    len(pmf)+1 entries, cdf[0] = 0, cdf[-1] = 2^precision, every symbol
    with frequency >= 1.  Rounding is repaired by taking from the largest
    bins (or giving to the most under-served one)."""
    total = 1 << precision
    pmf = np.clip(np.asarray(pmf, np.float64), 0, 1)
    freq = np.maximum(np.round(pmf * total).astype(np.int64), 1)
    excess = int(freq.sum()) - total
    while excess != 0:
        if excess > 0:
            i = int(np.argmax(freq))
            take = min(excess, int(freq[i]) - 1)
            if take == 0:
                raise ValueError("cannot normalize CDF")
            freq[i] -= take
            excess -= take
        else:
            i = int(np.argmax(pmf - freq / total))
            freq[i] += -excess
            excess = 0
    cdf = np.zeros(len(freq) + 1, np.int64)
    cdf[1:] = np.cumsum(freq)
    return cdf.astype(np.int32)


def gaussian_cdf_table(scale: float, max_abs: int,
                       precision: int = CDF_PRECISION) -> np.ndarray:
    """Integer CDF of a zero-mean discretized Gaussian over
    [-max_abs..max_abs] plus a final overflow (escape) bucket."""
    s = max(float(scale), SCALE_MIN)
    v = np.arange(-max_abs, max_abs + 1, dtype=np.float64)
    erf = np.vectorize(math.erf)
    upper = 0.5 * (1 + erf((v + 0.5) / (s * math.sqrt(2))))
    lower = 0.5 * (1 + erf((v - 0.5) / (s * math.sqrt(2))))
    pmf = upper - lower
    overflow = max(1.0 - pmf.sum(), 0.0)
    return quantize_cdf(np.concatenate([pmf, [overflow]]), precision)


SCALE_TABLE_SIZE = 64


def default_scale_table(smin: float = SCALE_MIN, smax: float = 256.0,
                        n: int = SCALE_TABLE_SIZE) -> np.ndarray:
    """Log-spaced scale bins shared by encoder and decoder (float64)."""
    return np.exp(np.linspace(np.log(smin), np.log(smax), n))


def scale_to_index(scale: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Each scale -> smallest table index with table[i] >= scale."""
    idx = np.searchsorted(table, np.asarray(scale), side="left")
    return np.clip(idx, 0, len(table) - 1).astype(np.int32)
