"""GDN / IGDN (generalized divisive normalization).

The port of the JAX package's ``ops/gdn.py``, on NCHW tensors:

    y_c = x_c / sqrt(beta_c + sum_d gamma[d, c] * x_d^2)     (GDN)
    y_c = x_c * sqrt(beta_c + sum_d gamma[d, c] * x_d^2)     (IGDN)

beta and gamma are stored raw and reparameterized as the JAX package does,
``lower_bound(v, sqrt(min + 2^-18))^2 - 2^-18``.  ``lower_bound`` is a max
in value, and in its gradient JAX's straight-through bound: a gradient
that would push a clipped value up passes.  A plain clamp would block it,
and gamma's off-diagonal entries, which start at 0 below the bound, would
never train.  The channel mix is a 1x1 convolution whose weight is gamma
transposed.

GDN runs in its input's dtype.  On a bf16 input (the serving fast path)
it follows the JAX package's ``dtype`` branch: x^2 and gamma rounded to
bf16, the mix summed in float32 and never rounded (a bf16 conv would round
it; each product of two bf16 values is exact in float32, so the mix is a
float32 conv of the bf16-rounded operands), the sqrt and the divide in
float32, and only the result cast to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_PEDESTAL = 2.0 ** -18


class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    would push x up (g < 0 under descent), and is 0 elsewhere."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, bound: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        keep = (x >= ctx.bound) | (g < 0)
        return torch.where(keep, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """JAX's ``lower_bound``: a max with a straight-through gradient
    toward the feasible side."""
    return _LowerBound.apply(x, bound)


def reparam(v: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    bound = (minimum + _PEDESTAL) ** 0.5
    return torch.square(lower_bound(v, bound)) - _PEDESTAL


def _reparam_init(value: float) -> float:
    return (value + _PEDESTAL) ** 0.5


class GDN(nn.Module):
    """Channelwise GDN over NCHW; ``inverse=True`` gives IGDN."""

    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.beta_min = beta_min
        self.gamma_init = gamma_init
        self.beta = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels, channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The JAX package's init: beta 1 and gamma ``gamma_init`` times the
        identity, both as raw (pre-reparameterization) values."""
        self.beta.fill_(_reparam_init(1.0))
        self.gamma.copy_(_reparam_init(self.gamma_init)
                         * torch.eye(self.gamma.shape[0]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = reparam(self.beta, self.beta_min)
        gamma = reparam(self.gamma).to(x.dtype).float()
        c = gamma.shape[0]
        mix = F.conv2d(torch.square(x).float(),
                       gamma.t().reshape(c, c, 1, 1), beta)
        norm = torch.sqrt(mix)
        y = x.float()
        return (y * norm if self.inverse else y / norm).to(x.dtype)
