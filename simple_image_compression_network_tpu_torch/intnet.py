"""Wrap-semantics QAT: train int4 weights FOR the exact integer net.

The port of the JAX package's ``intnet.py``.  It trains the reference's
topology (``config.py``) through the exact integer path itself, so the
shipped weights are good under the deployed semantics: the mod-256
accumulator wrap and the MSB-ReLU.

Mechanics, as in the JAX package:

* **Float shadow weights** ``w{i}``/``b{i}`` with straight-through int4 /
  int8 quantization (round and clip; gradient the identity).
* **Exact forward value, float gradients**: each layer computes the float
  accumulator ``acc_f`` (the gradient path) and the exact integer layer;
  it returns ``exact + (grad_path - grad_path.detach())``, so the forward
  value IS the deployed bit-exact net while gradients flow through the
  float path (the wrap is a shifted identity on every interval, so its
  a.e. derivative is 1).
* **Modes**: ``"float"`` (continuous relaxation, clip epilogue, no
  integer path), ``"clip"`` (exact integers, the epilogue clips acc + b to
  [-128, 127]) and ``"wrap"`` (the reference's semantics).
* **Out-of-window penalty**: mean ReLU(|acc + b| - 127) / 128 a layer.
* **Rate**: ``codec/entropy.FactorizedEntropy`` over the 192-channel
  latent; **display**: ``disp_a * y + disp_b`` (``"half"`` wire, x >> 1) or
  the fixed YCoCg display (``"ycocg"`` wire).

On the card the wrap-mode value of every layer is kernel A, through the
per-layer forms ``conv_fast.conv2d_int8_s2d`` / ``deconv2d_int8_d2s``
(which rewrite the freshly rounded shadows on every call); on the CPU
those run kernel A's plain version.  Kernel A gives ``max(pre, 0)``, which
cannot tell ``pre == 0`` from ``pre < 0``, so the gradient mask (and the
clip mode's value) come from ``round(acc_f)``: every partial sum of
``acc_f`` is an integer below 2^24 in magnitude (inputs <= 127, weights in
[-8, 7], |acc| <= 25 * 192 * 127 * 8 < 2^24), so float32 holds it
exactly, given convolutions that are direct or implicit GEMMs (every
cuDNN algorithm of a stride-2 conv and of its transpose; FFT and Winograd
need stride 1) and no TF32 (``train.full_float32``).

Params: a flat dict of float32 tensors, ``w0``..``w7`` ``[O, k, k, I]``,
``b0``..``b7`` ``[O]``, ``ent.H0``.. (the entropy model's parameters) and
``disp_a``/``disp_b`` ``[3]``; ``intnet_params_to_jax`` /
``intnet_params_from_jax`` carry them to and from the JAX package's tree
``{"w0", .., "ent": {"params": {..}}, "disp_a", "disp_b"}``.
``export_int_params`` rounds the shadows into the int8 npz layout of
``checkpoints/reference_weights.npz``.  Activations are NHWC at the
module's edges, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import train
from .codec.entropy import FactorizedEntropy
from .codec.wavelet_codec import display_ycocg, wire_ycocg
from .config import ModelConfig, REFERENCE_NET
from .ops import conv_fast, conv_int
from .utils.device import resolve_device

Params = Dict[str, torch.Tensor]
ENT = "ent."


def _clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(v, lo), hi), whose gradient is 1/2 where v
    equals a bound (torch.clamp's is 1 there)."""
    return torch.minimum(torch.maximum(v, v.new_tensor(lo)),
                         v.new_tensor(hi))


def ste_round_clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """round+clip with straight-through gradients (identity inside clip),
    in JAX's float order ``v + stop_gradient(q - v)``."""
    q = torch.clamp(torch.round(v), lo, hi)
    return v + (q - v).detach()


def _acc_f(x: torch.Tensor, wq: torch.Tensor, transposed: bool
           ) -> torch.Tensor:
    """The float accumulator of the layer (NHWC in and out), the integer
    layer's algebra: a 5x5/s2/p2 cross-correlation, or the lhs-dilated
    conv with padding (2, 3) and no kernel flip, which is
    ``conv_transpose2d`` of the flipped kernel with padding 2 and one
    extra output row and column."""
    xn = x.permute(0, 3, 1, 2)
    if transposed:
        w = wq.permute(3, 0, 1, 2).flip(2, 3)          # (I, O, kx, ky)
        k = wq.shape[1]
        lo = k - 2 - 1
        out = F.conv_transpose2d(xn, w, stride=2, padding=lo,
                                 output_padding=1)
    else:
        out = F.conv2d(xn, wq.permute(0, 3, 1, 2), stride=2, padding=2)
    return out.permute(0, 2, 3, 1)


def _layer(x: torch.Tensor, wf: torch.Tensor, bf: torch.Tensor,
           transposed: bool, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One exact-int-forward / float-backward layer.

    x: f32 holding exact ints in [0, 255] (continuous in "float" mode).
    Returns (y f32 ints in [0, 127], out-of-window penalty scalar)."""
    if mode == "float":
        wq = _clip(wf, -8.0, 7.0)          # int4 magnitude, no rounding
        bq = _clip(bf, -128.0, 127.0)
    else:
        wq = ste_round_clip(wf, -8.0, 7.0)
        bq = ste_round_clip(bf, -128.0, 127.0)
    acc_f = _acc_f(x, wq, transposed) + bq
    pen = torch.mean(F.relu(torch.abs(acc_f) - 127.0) / 128.0)
    if mode == "float":
        return _clip(acc_f, 0.0, 127.0), pen

    # the exact integer layer (value path, no gradients)
    acc_b = torch.round(acc_f.detach()).to(torch.int32)    # acc_i + b
    if mode == "wrap":
        xi = conv_int.to_wire_int8(x.detach().to(torch.uint8))
        wi = wq.detach().to(torch.int8)
        bi = bq.detach().to(torch.int8)
        if transposed:
            y_exact = conv_fast.deconv2d_int8_d2s(xi, wi, bi)
        else:
            y_exact = conv_fast.conv2d_int8_s2d(xi, wi, bi)
        # wrap is a shifted identity on every interval: only the MSB-ReLU
        # gates the gradient
        mask = conv_int.wrap_to_int8(acc_b) >= 0
    elif mode == "clip":
        pre = torch.clamp(acc_b, -128, 127)
        # saturated units (acc > 127) have zero derivative
        mask = (pre >= 0) & (acc_b < 128)
        y_exact = torch.clamp_min(pre, 0)
    else:
        raise ValueError(mode)
    grad_path = mask.to(torch.float32) * acc_f
    y = y_exact.to(torch.float32) + (grad_path - grad_path.detach())
    return y, pen


def forward(params: Params, x_half: torch.Tensor,
            cfg: ModelConfig = REFERENCE_NET, *, mode: str = "wrap"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_half: (B, X, Y, 3) f32 ints in [0, 127] (the >>1 wire input).

    Returns (x_hat f32 ints in [0, 127], latent z f32 ints in [0, 127],
    the total out-of-window penalty)."""
    h = x_half
    pens = []
    n_analysis = len(cfg.analysis)
    for i, layer in enumerate(cfg.layers):
        h, p = _layer(h, params[f"w{i}"], params[f"b{i}"], layer.transposed,
                      mode)
        pens.append(p)
        if i == n_analysis - 1:
            z = h
    return h, z, sum(pens)


@dataclasses.dataclass(frozen=True)
class IntNetTrainConfig:
    rd_lambda: float = 0.03
    oob_weight: float = 1.0
    mode: str = "wrap"            # "float" | "clip" | "wrap"
    wire: str = "half"            # "half" (x>>1, learned display) |
    #                               "ycocg" (intnet_haar wire profile,
    #                               fixed display)
    lr: float = 5e-3
    crop: int = 256
    batch: int = 8
    ent_init_scale: float = 60.0  # latent symbols span 0..127


@functools.lru_cache(maxsize=None)
def _entropy(channels: int, init_scale: float) -> FactorizedEntropy:
    """A shape-only FactorizedEntropy; ``loss_fn`` calls it on the
    params' ``ent.*`` tensors (``torch.func.functional_call``)."""
    return FactorizedEntropy(channels, init_scale=init_scale)


def init_params(cfg: IntNetTrainConfig,
                generator: Optional[torch.Generator] = None,
                net: ModelConfig = REFERENCE_NET, device=None) -> Params:
    """Small-magnitude init, as the JAX package draws it: each weight
    ``max(0.3, 24 / sqrt(fan_in)) * N(0, 1)``, zero biases, the entropy
    model's flax init (``init_scale``), ``disp_a = 2``, ``disp_b = 0``.
    Drawn on the CPU from ``generator``, then placed on ``device`` (the
    card by default; it raises without one unless given "cpu")."""
    dev = resolve_device(device)
    params: Params = {}
    for i, layer in enumerate(net.layers):
        fan_in = layer.kernel ** 2 * layer.in_ch
        std = max(0.3, 24.0 / np.sqrt(fan_in))
        params[f"w{i}"] = std * torch.randn(layer.weight_shape,
                                            generator=generator)
        params[f"b{i}"] = torch.zeros((layer.out_ch,))
    ent = FactorizedEntropy(net.latent_shape[-1],
                            init_scale=cfg.ent_init_scale)
    ent.reset_parameters(generator)
    params.update({ENT + k: v.detach().clone()
                   for k, v in ent.named_parameters()})
    params["disp_a"] = torch.full((3,), 2.0)
    params["disp_b"] = torch.zeros((3,))
    return {k: v.to(device=dev, dtype=torch.float32)
            for k, v in params.items()}


def loss_fn(params: Params, batch_u8: torch.Tensor, cfg: IntNetTrainConfig,
            net: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch_u8: (N, X, Y, 3) f32 ints in [0, 255], the original
    intensities.  Returns (loss, JAX's metrics dict)."""
    if cfg.wire == "ycocg":
        x_in = wire_ycocg(batch_u8)
    else:
        x_in = torch.floor(batch_u8 / 2.0)
    x_hat, z, oob = forward(params, x_in, net, mode=cfg.mode)
    ent = _entropy(net.latent_shape[-1], cfg.ent_init_scale)
    bits = torch.func.functional_call(
        ent, {k[len(ENT):]: v for k, v in params.items()
              if k.startswith(ENT)}, (z,))
    num_pixels = batch_u8.shape[0] * batch_u8.shape[1] * batch_u8.shape[2]
    bpp = bits / num_pixels
    if cfg.wire == "ycocg":
        disp = display_ycocg(x_hat)
    else:
        # learned display map: x_disp = disp_a * y + disp_b (header consts)
        disp = params["disp_a"] * x_hat + params["disp_b"]
    mse01 = torch.mean(torch.square(disp - batch_u8)) / 255.0 ** 2
    loss = bpp + cfg.rd_lambda * (255.0 ** 2) * mse01 + cfg.oob_weight * oob
    return loss, {"loss": loss, "bpp": bpp, "mse": mse01, "oob": oob,
                  "psnr": -10.0 * torch.log10(torch.clamp(mse01,
                                                          min=1e-12))}


def grad_mask_from_structure(ref_params: Dict[str, np.ndarray],
                             template: Params) -> Params:
    """Per-element mask: 1 where a reference int param is zero (an unused
    pathway free to train), 0 where it is part of the constructed
    structure; the entropy model, the display constants and anything
    without a reference entry are fully trainable.  Fine-tunes from the
    Haar construction without letting gradients destroy it."""
    mask: Params = {}
    for k, v in template.items():
        if k in ref_params and not k.startswith("disp"):
            mask[k] = torch.as_tensor(np.asarray(ref_params[k]) == 0).to(
                device=v.device, dtype=torch.float32)
        else:
            mask[k] = torch.ones_like(v, requires_grad=False)
    return mask


class IntNetOptimizer:
    """``build_optimizer``'s optax chains on ``train.ClipAdam``:

    * plain: ``chain(clip_by_global_norm(1), adam(lr))`` over every leaf;
    * ``grad_mask``: the same chain, then the update multiplied by the
      mask, so the clip's norm and Adam's moments include the masked
      elements and only the update is zeroed;
    * ``ent_only``: ``multi_transform`` with ``set_to_zero`` on every
      leaf but the entropy model's: the clip's norm and Adam's state cover
      the entropy leaves alone, and every other leaf stays as it was."""

    def __init__(self, cfg: IntNetTrainConfig, ent_only: bool = False,
                 grad_mask: Optional[Params] = None):
        self.tx = train.ClipAdam(cfg.lr)
        self.ent_only = ent_only
        self.grad_mask = grad_mask

    def names(self, params: Params) -> list:
        """The leaves that take part, in ``params``' order."""
        return [k for k in params if not self.ent_only or k.startswith(ENT)]

    def init(self, params: Params) -> train.AdamState:
        return self.tx.init({k: params[k] for k in self.names(params)})

    def update(self, params: Params, grads, state: train.AdamState) -> None:
        """One step on ``params`` in place; ``grads`` in ``names``'
        order."""
        names = self.names(params)
        mask = (None if self.grad_mask is None
                else {k: self.grad_mask[k] for k in names})
        self.tx.update({k: params[k] for k in names}, list(grads), state,
                       mask=mask)


def build_optimizer(cfg: IntNetTrainConfig, *, ent_only: bool = False,
                    grad_mask: Optional[Params] = None) -> IntNetOptimizer:
    """ent_only=True updates just the entropy model's params (the warm-up
    that adapts the rate proxy to a constructed net); grad_mask (per-
    element 0/1, ``grad_mask_from_structure``) multiplies the updates."""
    return IntNetOptimizer(cfg, ent_only=ent_only, grad_mask=grad_mask)


def make_train_step(cfg: IntNetTrainConfig, net: ModelConfig, *,
                    ent_only: bool = False,
                    grad_mask: Optional[Params] = None):
    """Returns ``step(params, opt_state, batch) -> metrics``: one step on
    ``batch`` (f32 ints in [0, 255], NHWC, on the params' device), the
    params and ``opt_state`` updated in place, the metrics left on the
    device.  Only the leaves that take part are differentiated."""
    tx = build_optimizer(cfg, ent_only=ent_only, grad_mask=grad_mask)

    def step(params: Params, opt_state: train.AdamState,
             batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        names = tx.names(params)
        for k in names:
            params[k].requires_grad_(True)
        with train.full_float32():
            _, metrics = loss_fn(params, batch, cfg, net)
            # a leaf the loss does not reach (disp_* on the ycocg wire)
            # takes a zero gradient, as jax.grad gives it
            grads = torch.autograd.grad(metrics["loss"],
                                        [params[k] for k in names],
                                        allow_unused=True,
                                        materialize_grads=True)
        tx.update(params, grads, opt_state)
        return {k: v.detach() for k, v in metrics.items()}

    step.tx = tx
    return step


def make_train_block(cfg: IntNetTrainConfig, net: ModelConfig, *,
                     ent_only: bool = False,
                     grad_mask: Optional[Params] = None):
    """Returns ``block(params, opt_state, bank, seed, start, n_steps) ->
    mean metrics``: steps ``start .. start + n_steps - 1``, each drawing
    its crops on the device from ``bank`` (uint8 on the params' device)
    from the step's generator (``train.step_generator(seed, step)``, so
    a phase seeded by ``seed`` draws the same crops however its blocks
    fall).  Nothing in a block waits for the device; the caller reads the
    metrics once a block."""
    step_fn = make_train_step(cfg, net, ent_only=ent_only,
                              grad_mask=grad_mask)

    def block(params: Params, opt_state: train.AdamState,
              bank: torch.Tensor, seed: int, start: int,
              n_steps: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=bank.device)
        tot: Dict[str, torch.Tensor] = {}
        for i in range(start, start + n_steps):
            train.step_generator(gen, seed, i)
            batch = train.device_random_crops_u8(
                bank, cfg.crop, cfg.batch, gen).to(torch.float32)
            m = step_fn(params, opt_state, batch)
            tot = m if not tot else {k: tot[k] + m[k] for k in tot}
        return {k: v / n_steps for k, v in tot.items()}

    block.tx = step_fn.tx
    return block


def export_int_params(params: Params, net: ModelConfig = REFERENCE_NET
                      ) -> Dict[str, np.ndarray]:
    """Shadow floats -> the int8 npz layout of reference_weights.npz, and
    the display map's float header constants."""
    out: Dict[str, np.ndarray] = {}

    def host(k: str) -> np.ndarray:
        return params[k].detach().cpu().numpy()
    for i in range(len(net.layers)):
        out[f"w{i}"] = np.clip(np.round(host(f"w{i}")), -8, 7).astype(
            np.int8)
        out[f"b{i}"] = np.clip(np.round(host(f"b{i}")), -128, 127).astype(
            np.int8)
    out["disp_a"] = np.asarray(host("disp_a"), np.float32)
    out["disp_b"] = np.asarray(host("disp_b"), np.float32)
    return out


def intnet_params_to_jax(params: Params) -> dict:
    """The port's params (or a tree of the same names: Adam's moments) ->
    the JAX package's intnet tree of numpy arrays, ``{"b0", .., "disp_a",
    "disp_b", "ent": {"params": {"H0", ..}}, "w0", ..}``, keys sorted as
    JAX's tree functions leave them.  The shadows keep their
    ``[O, k, k, I]`` layout."""
    ent = {k[len(ENT):]: v for k, v in params.items() if k.startswith(ENT)}
    tree = {k: v for k, v in params.items() if not k.startswith(ENT)}

    def host(v: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(v.detach().cpu().numpy())
    out = {k: host(v) for k, v in tree.items()}
    out["ent"] = {"params": {k: host(ent[k]) for k in sorted(ent)}}
    return {k: out[k] for k in sorted(out)}


def intnet_params_from_jax(tree: dict) -> Params:
    """The JAX package's intnet tree -> the port's flat params (CPU
    float32 tensors, in ``init_params``' order)."""
    def t(v) -> torch.Tensor:
        return torch.from_numpy(np.array(v, np.float32))
    n = sum(1 for k in tree if k.startswith("w"))
    out: Params = {}
    for i in range(n):
        out[f"w{i}"] = t(tree[f"w{i}"])
        out[f"b{i}"] = t(tree[f"b{i}"])
    ent = tree["ent"]["params"]
    # FactorizedEntropy's order: H0, b0, a0, H1, .., b{K-1}
    for k in sorted(ent, key=lambda k: (int(k[1:]), "Hba".index(k[0]))):
        out[ENT + k] = t(ent[k])
    out["disp_a"] = t(tree["disp_a"])
    out["disp_b"] = t(tree["disp_b"])
    return out
