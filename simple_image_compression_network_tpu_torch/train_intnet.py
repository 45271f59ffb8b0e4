"""Train wrap-semantics int4 weights for the bit-exact integer codec.

The port of the JAX package's ``scripts/train_intnet.py``, as ``main(argv)``
(``intnet.py`` holds the mechanics).  Usage:

    python -m simple_image_compression_network_tpu_torch.train_intnet \\
        [--float-steps 4000] [--pretrain 3000] [--steps 20000] \\
        [--init-haar haar422 [--freeze-structure]] [--device cpu] \\
        [--out-dir DIR]

Phases, each with a fresh optimizer state:

  0. ``ent-warmup`` (``--ent-warmup`` steps): the entropy model alone;
  1. ``float`` (``--float-steps``): the continuous relaxation;
  2. ``clip`` (``--pretrain``): exact integers with a clip epilogue and a
     strong out-of-window penalty, where clip and wrap agree;
  3. ``wrap`` (``--steps``, in ``--main-mode``): the reference's exact
     mod-256 + MSB-ReLU semantics, identity-STE through the wrap.

``--resume`` (a shadow file of either package) or ``--init-haar`` (the
wavelet profile's construction, on its YCoCg wire) skip phases 1 and 2.
Each phase runs in blocks of ``--log-every`` steps (the last block
shorter when ``--log-every`` does not divide the phase), its crops drawn
on the device from the training bank, one read of the metrics a block.

Writes, to ``--out-dir`` (the repository's ``checkpoints/`` by default):
``<out>.msgpack`` (the float shadows in the JAX package's tree),
``<out>.npz`` (the int8 layout of ``reference_weights.npz``) and the
static latent CDFs ``<out without _trained>_cdfs.npz``, fitted by
``codec/int_codec.build_static_cdfs`` on an ``IntCodecNet`` of the
exported integers (kernel A on the card) over 8 images of the crop's side
(256 by default, the JAX package's fixed side) on the wire the net was
trained on.  Runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch

from . import intnet, intnet_haar
from .codec import int_codec
from .codec.wavelet_codec import PROFILES
from .config import reference_net_for_input
from .models.codec_int import IntCodecNet
from .utils import data as datalib
from .utils import train_ckpt, weights_io
from .utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each phase's crops come from its own seeds (the JAX package's fold_in
# indices of its phases)
PHASE_IDS = {"clip": 1, "wrap": 2, "float": 3, "ent-warmup": 4}


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--float-steps", type=int, default=4000,
                    dest="float_steps")
    ap.add_argument("--pretrain", type=int, default=3000)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--rd-lambda", type=float, default=0.03,
                    dest="rd_lambda")
    ap.add_argument("--oob-pre", type=float, default=3.0)
    ap.add_argument("--oob", type=float, default=0.3)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=250)
    ap.add_argument("--resume", default=None,
                    help="msgpack shadow checkpoint to resume from "
                         "(skips the float and clip phases)")
    ap.add_argument("--init-haar", default=None, dest="init_haar",
                    choices=sorted(PROFILES),
                    help="initialize shadows from a wavelet profile; skips "
                         "the float/clip phases and fine-tunes in wrap mode "
                         "on the profile's wire domain")
    ap.add_argument("--wire", default=None, choices=["half", "ycocg"],
                    help="wire domain (default: half, or ycocg when "
                         "--init-haar)")
    ap.add_argument("--main-mode", default="wrap", dest="main_mode",
                    choices=["wrap", "clip"],
                    help="accumulator mode of the main phase")
    ap.add_argument("--freeze-structure", action="store_true",
                    dest="freeze_structure",
                    help="with --init-haar: train only the construction's "
                         "zero entries; structural taps and biases stay")
    ap.add_argument("--ent-warmup", type=int, default=0, dest="ent_warmup",
                    help="steps of entropy-model-only training before the "
                         "main phases")
    ap.add_argument("--out", default="intnet_trained")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "checkpoints"),
                    dest="out_dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def run_phase(cfg: intnet.IntNetTrainConfig, net, params: Dict,
              bank: torch.Tensor, seed: int, steps: int, log_every: int,
              tag: str, ent_only: bool = False, grad_mask=None) -> Dict:
    """``steps`` steps of one phase on ``params`` (in place), in blocks
    of ``log_every``; returns ``params``."""
    block = intnet.make_train_block(cfg, net, ent_only=ent_only,
                                    grad_mask=grad_mask)
    opt_state = block.tx.init(params)
    step, t0 = 0, time.perf_counter()
    while step < steps:
        n = min(log_every, steps - step)
        m = block(params, opt_state, bank, seed, step, n)
        m = dict(zip(m, torch.stack(list(m.values())).tolist()))
        step += n
        rate = n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        print(f"[{tag}] step {step:6d}  loss {m['loss']:.4f}  "
              f"bpp {m['bpp']:.4f}  psnr {m['psnr']:.2f}  "
              f"oob {m['oob']:.5f}  ({rate:.2f} steps/s)", flush=True)
    return params


def _bank(seed: int) -> np.ndarray:
    """The training images: the JAX script's mixed bank."""
    return datalib.training_bank(48, 512, 512, seed=seed)


def fit_static_cdfs(ints: Dict[str, np.ndarray], wire: str, seed: int,
                    device, side: int) -> np.ndarray:
    """The shipped codec's static latent CDFs for the exported net, fitted
    on 8 ``side`` x ``side`` images of ``training_bank(seed + 7)`` on its
    wire."""
    imgs = datalib.training_bank(8, side, side, seed=seed + 7)
    if wire == "ycocg":
        batches = [intnet_haar.to_wire_ycocg(imgs[i:i + 1])
                   for i in range(8)]
    else:
        batches = [(imgs[i:i + 1] // 2).view(np.int8) for i in range(8)]
    net = IntCodecNet(weights_io.params_from_jax(
        {k: v for k, v in ints.items() if not k.startswith("disp")}),
        device=device)
    return int_codec.build_static_cdfs(
        net, [torch.from_numpy(b).to(net.device) for b in batches])


def main(argv=None) -> Dict[str, torch.Tensor]:
    """Train; returns the float shadows (on the training device)."""
    args = _parse(argv)
    device = resolve_device(args.device)
    net = reference_net_for_input(args.crop, args.crop)
    wire = args.wire or ("ycocg" if args.init_haar else "half")
    base = dict(rd_lambda=args.rd_lambda, lr=args.lr, crop=args.crop,
                batch=args.batch, wire=wire)
    cfg_float = intnet.IntNetTrainConfig(mode="float",
                                         oob_weight=args.oob_pre, **base)
    cfg_pre = intnet.IntNetTrainConfig(mode="clip", oob_weight=args.oob_pre,
                                       **base)
    cfg_wrap = intnet.IntNetTrainConfig(mode=args.main_mode,
                                        oob_weight=args.oob, **base)
    params = intnet.init_params(
        cfg_wrap, torch.Generator().manual_seed(args.seed), net, device)
    grad_mask = None
    if args.resume:
        params = train_ckpt.restore_params(
            args.resume, params, to_jax=intnet.intnet_params_to_jax,
            from_jax=intnet.intnet_params_from_jax)
        print(f"resumed shadows from {args.resume}")
    elif args.init_haar:
        hp = intnet_haar.haar_params(
            net, det2_keep=PROFILES[args.init_haar]["det2_keep"])
        for k, v in hp.items():
            if not k.startswith("disp"):
                params[k] = torch.from_numpy(v.astype(np.float32)).to(device)
        print(f"initialized shadows from wavelet profile {args.init_haar}")
        if args.freeze_structure:
            grad_mask = intnet.grad_mask_from_structure(hp, params)
            n_free = sum(float(v.sum()) for k, v in grad_mask.items()
                         if k.startswith("w"))
            print(f"structure frozen: {n_free:.0f} free weight elements")

    bank = torch.from_numpy(_bank(args.seed)).to(device)
    seeds = {tag: (args.seed << 3) + i for tag, i in PHASE_IDS.items()}
    if args.ent_warmup:
        run_phase(cfg_wrap, net, params, bank, seeds["ent-warmup"],
                  args.ent_warmup, args.log_every, "ent-warmup",
                  ent_only=True)
    skip_pre = bool(args.resume or args.init_haar)
    if args.float_steps and not skip_pre:
        run_phase(cfg_float, net, params, bank, seeds["float"],
                  args.float_steps, args.log_every, "float")
    if args.pretrain and not skip_pre:
        run_phase(cfg_pre, net, params, bank, seeds["clip"], args.pretrain,
                  args.log_every, "clip")
    run_phase(cfg_wrap, net, params, bank, seeds["wrap"], args.steps,
              args.log_every, "wrap", grad_mask=grad_mask)

    shadows = os.path.join(args.out_dir, args.out + ".msgpack")
    train_ckpt.save_params(shadows, params,
                           to_jax=intnet.intnet_params_to_jax)
    ints = intnet.export_int_params(params, net)
    weights = os.path.join(args.out_dir, args.out + ".npz")
    np.savez_compressed(weights, **ints)
    print("wrote", shadows)
    print("wrote", weights)
    cdfs = os.path.join(args.out_dir,
                        args.out.replace("_trained", "") + "_cdfs.npz")
    np.savez_compressed(cdfs, cdfs=fit_static_cdfs(ints, wire, args.seed,
                                                   device, args.crop))
    print("wrote", cdfs)
    return {k: v.detach() for k, v in params.items()}


if __name__ == "__main__":
    main()
