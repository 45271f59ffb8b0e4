"""Entropy models and integer CDF tables: what the hyperprior codec needs.

The port's own copy of part of the JAX package's ``codec/entropy.py``:

* ``FactorizedEntropy``: the learned per-channel CDF of the hyper-latent z
  (forward only: ``likelihood``), whose probabilities build the z tables.
* ``quantize_cdf``, ``gaussian_cdf_table``, ``default_scale_table`` and
  ``scale_to_index``: the integer tables the rANS coder consumes, computed
  with numpy in float64 exactly as the JAX package computes them.

Training quantizers and ``GaussianConditional`` are not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SCALE_MIN = 0.11


class FactorizedEntropy(nn.Module):
    """Per-channel learned univariate CDF (entropy bottleneck).

    c(x) = sigmoid(f_K(...f_1(x))), f_k(x) = softplus(H_k) x + b_k + a_k
    tanh(softplus(H_k) x + b_k).  Parameters keep the JAX package's names
    and shapes: H{k} (C, d_{k+1}, d_k), b{k} and a{k} (C, d_{k+1}, 1)."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3),
                 init_scale: float = 10.0):
        super().__init__()
        self.channels = channels
        dims = (1,) + tuple(filters) + (1,)
        self.n_layers = len(dims) - 1
        scale = init_scale ** (1.0 / (len(filters) + 1))
        for k in range(self.n_layers):
            h_init = float(np.log(np.expm1(1.0 / scale / dims[k + 1])))
            self.register_parameter(f"H{k}", nn.Parameter(
                torch.full((channels, dims[k + 1], dims[k]), h_init)))
            self.register_parameter(f"b{k}", nn.Parameter(
                torch.zeros((channels, dims[k + 1], 1))))
            if k < self.n_layers - 1:
                self.register_parameter(f"a{k}", nn.Parameter(
                    torch.zeros((channels, dims[k + 1], 1))))

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
