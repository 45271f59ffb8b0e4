"""Rate-distortion training of the float codec models.

The port of the JAX package's ``train.py``:

    loss = bpp + lambda * 255^2 * MSE

(the standard RD Lagrangian; distortion in 8-bit-scaled MSE so published
lambda values transfer), minimised with optax's ``chain(clip_by_global_norm
(1.0), adam(lr))`` written out here (``ClipAdam``): a gradient whose global
norm is below 1 passes unchanged, a larger one is divided by its norm.

A step is a forward, ``torch.autograd.grad`` and the update, all on the
model's device; the parameters and the optimizer state are updated in
place.  ``make_train_block`` runs K steps with the crops and the noise drawn
on the device from a device-resident uint8 bank, and never waits for the
device: the metrics stay there until the caller reads them once a block.
The float convolutions run on cuDNN in full float32 (no TF32), as the JAX
package's run in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.hyperprior import (FactorizedPrior, MeanScaleHyperprior,
                                ScaleHyperprior)

MODELS = {"hyperprior": ScaleHyperprior, "meanscale": MeanScaleHyperprior,
          "factorized": FactorizedPrior}
MAX_GRAD_NORM = 1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str = "hyperprior"    # "hyperprior" | "meanscale" | "factorized"
    n: int = 128
    m: int = 192
    rd_lambda: float = 0.01
    lr: float = 1e-4
    crop: int = 256
    batch: int = 8


def build_model(cfg: TrainConfig, device=None):
    """A trainable model of ``cfg`` on ``device`` (default: the card; it
    raises without one unless given ``device="cpu"``)."""
    if cfg.model not in MODELS:
        raise ValueError(cfg.model)
    model = MODELS[cfg.model](cfg.n, cfg.m, device=device)
    model.requires_grad_(True)
    return model


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count (kept on the host, so
    the bias corrections need no read from the device) and the moments,
    by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class ClipAdam:
    """``optax.chain(clip_by_global_norm(MAX_GRAD_NORM), adam(lr))``, with
    optax's arithmetic: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, the bias
    corrections ``1 - b**count`` in float32."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            0, {k: torch.zeros_like(v, requires_grad=False)
                for k, v in params.items()},
            {k: torch.zeros_like(v, requires_grad=False)
             for k, v in params.items()})

    @staticmethod
    def clip(grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax's ``clip_by_global_norm``: g where the global norm is
        below the bound, else g / norm * bound, chosen on the device."""
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < MAX_GRAD_NORM, torch.ones_like(norm),
                            norm / MAX_GRAD_NORM)
        return list(torch._foreach_div(grads, scale))

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: List[torch.Tensor], state: AdamState,
               mask: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Clip ``grads`` (in ``params``' order), then one Adam step on
        ``params`` and ``state``, in place.  ``mask``: per-element 0/1
        factors of the update, applied after Adam (optax's chain of the
        clip, Adam, then a mask: the norm and the moments include the
        masked elements)."""
        grads = self.clip(grads)
        names = list(params)
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                            alpha=1.0 - self.b2)
        state.count += 1
        one = np.float32(1.0)
        bc1 = float(one - np.float32(self.b1) ** np.float32(state.count))
        bc2 = float(one - np.float32(self.b2) ** np.float32(state.count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        step = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_mul_(step, -self.lr)
        if mask is not None:
            torch._foreach_mul_(step, [mask[k] for k in names])
        torch._foreach_add_([params[k] for k in names], step)


def build_optimizer(cfg: TrainConfig) -> ClipAdam:
    # clip: the GDN/RD objective occasionally produces huge gradients
    # (loss spikes mid-training); global-norm clipping keeps the
    # trajectory stable without lr tuning.
    return ClipAdam(cfg.lr)


def init_state(cfg: TrainConfig, seed: int = 0, device=None):
    """(model, opt_state) of a fresh run: the model initialised as flax
    does, drawn from a CPU generator seeded with ``seed`` (the same
    parameters on any device), and Adam's zero state."""
    model = build_model(cfg, device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model, build_optimizer(cfg).init(dict(model.named_parameters()))


def rd_loss(model, batch: torch.Tensor, noise: Optional[Dict],
            rd_lambda: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The RD loss of an NHWC batch in [0, 1] with the latents quantized
    by ``noise`` (None: rounded straight through), and its metrics."""
    out = model(batch, noise=noise)
    mse = torch.mean(torch.square(out["x_hat"] - batch))
    bpp = out["bpp"]
    loss = bpp + rd_lambda * (255.0 ** 2) * mse
    return loss, {"loss": loss, "bpp": bpp, "mse": mse,
                  "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12))}


def full_float32():
    """Full float32 convolutions: cuDNN without TF32 (a no-op on the
    CPU).  Algorithms are benchmarked once per shape; training needs no
    bitwise determinism (data-parallel ranks apply one averaged gradient
    to equal parameters, so they stay equal)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                      deterministic=False, allow_tf32=False)


GradMean = Callable[[List[torch.Tensor], Dict[str, torch.Tensor]],
                    Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]]


def make_train_step(cfg: TrainConfig, model,
                    grad_mean: Optional[GradMean] = None,
                    loss_fn: Optional[Callable] = None):
    """Returns ``train_step(opt_state, batch, noise) -> metrics``: one
    step of ``model`` on ``batch`` (NHWC, the model's device) with the
    latents quantized by ``noise``, updating the parameters and
    ``opt_state`` in place; the metrics stay on the device.

    ``grad_mean(grads, metrics)``, when given, returns the ranks'
    reductions of both (data-parallel or spatial training); the update
    then uses them.  ``loss_fn(model, batch, noise) -> (loss, metrics)``
    replaces ``rd_loss`` (a rank's share of the loss of a sharded
    batch)."""
    tx = build_optimizer(cfg)
    params = dict(model.named_parameters())
    leaves = list(params.values())
    if loss_fn is None:
        def loss_fn(model, batch, noise):
            return rd_loss(model, batch, noise, cfg.rd_lambda)

    def train_step(opt_state: AdamState, batch: torch.Tensor,
                   noise: Optional[Dict]) -> Dict[str, torch.Tensor]:
        with full_float32():
            loss, metrics = loss_fn(model, batch, noise)
            grads = list(torch.autograd.grad(loss, leaves))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if grad_mean is not None:
            grads, metrics = grad_mean(grads, metrics)
        tx.update(params, grads, opt_state)
        return metrics

    return train_step


def step_generator(generator: torch.Generator, seed: int,
                   step: int) -> torch.Generator:
    """``generator`` seeded for step ``step`` of a run seeded ``seed``
    (JAX's ``fold_in(key, step)``): a step draws the same crops and noise
    whether or not the run was resumed before it."""
    return generator.manual_seed((seed << 32) + step)


def device_random_crops(bank: torch.Tensor, crop: int, batch: int,
                        generator: torch.Generator) -> torch.Tensor:
    """On-device crop sampling: (N, X, Y, 3) uint8 bank -> (B, crop, crop,
    3) float32 in [0, 1], the image and offsets drawn from ``generator``
    (on the bank's device): no host transfer and no wait."""
    return device_random_crops_u8(bank, crop, batch, generator).to(
        torch.float32) / 255.0


def device_random_crops_u8(bank: torch.Tensor, crop: int, batch: int,
                           generator: torch.Generator) -> torch.Tensor:
    """``device_random_crops`` before the scaling: the uint8 crops."""
    n, x, y, _ = bank.shape
    dev = bank.device
    idx = torch.randint(0, n, (batch,), generator=generator, device=dev)
    ox = torch.randint(0, x - crop + 1, (batch,), generator=generator,
                       device=dev)
    oy = torch.randint(0, y - crop + 1, (batch,), generator=generator,
                       device=dev)
    r = torch.arange(crop, device=dev)
    return bank[idx[:, None, None], (ox[:, None] + r)[:, :, None],
                (oy[:, None] + r)[:, None, :]]


def make_train_block(cfg: TrainConfig, model):
    """Returns ``block(opt_state, bank, seed, start, n_steps) -> mean
    metrics``: steps ``start .. start + n_steps - 1``, each drawing its
    crops from ``bank`` (uint8 on the model's device) and its noise on the
    device from the step's generator (``step_generator``).  Nothing in a
    block waits for the device; its metrics (device tensors) are the
    means over the block."""
    step_fn = make_train_step(cfg, model)
    gen = torch.Generator(device=model.device)

    def block(opt_state: AdamState, bank: torch.Tensor, seed: int,
              start: int, n_steps: int) -> Dict[str, torch.Tensor]:
        tot: Dict[str, torch.Tensor] = {}
        for i in range(start, start + n_steps):
            step_generator(gen, seed, i)
            batch = device_random_crops(bank, cfg.crop, cfg.batch, gen)
            noise = model.noise_like(batch.shape, gen)
            m = step_fn(opt_state, batch, noise)
            tot = m if not tot else {k: tot[k] + m[k] for k in tot}
        return {k: v / n_steps for k, v in tot.items()}

    return block
