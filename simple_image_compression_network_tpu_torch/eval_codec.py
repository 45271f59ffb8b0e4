"""Rate-distortion evaluation harness of the port.

The counterpart of the JAX package's ``eval_codec.py``: evaluates one codec
on a folder of images or on synthetic 1/f images and prints one JSON line,
the mean bpp and PSNR over the images (real container bytes; every
reconstruction decoded from its container):

* ``int8``: the bit-exact integer codec, ``checkpoints/reference_weights.npz``
  with the static tables ``latent_cdfs.npz`` (kernels A, B and C);
* ``wavelet``: ``WaveletCodec`` under ``--profile``;
* ``hyperprior`` / ``meanscale``: ``HyperCodec`` / ``MeanScaleCodec`` on a
  trained ``--ckpt``, in the serial format: a released
  ``*.params.msgpack``, or a training checkpoint (``ckpt_*.msgpack`` of
  either package's ``train_loop``, at the training default N = 128,
  M = 192) whose parameters ``utils/train_ckpt.restore`` takes.

Usage:
    python -m simple_image_compression_network_tpu_torch.eval_codec \\
        [--data DIR] [--codec int8|hyperprior|meanscale|wavelet] \\
        [--ckpt checkpoints/hp_meanscale_l0.01.params.msgpack] \\
        [--profile haar422] [--n-synthetic 4] [--device cpu]

Runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

from .codec import int_codec
from .utils import data as datalib
from .utils import weights_io
from .utils.device import resolve_device

_CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def _pad_to_16(img: np.ndarray, mult: int = 16) -> np.ndarray:
    x, y, _ = img.shape
    px, py = (-x) % mult, (-y) % mult
    return np.pad(img, ((0, px), (0, py), (0, 0)), mode="edge")


def _summary(rows: List[Dict[str, float]]) -> Dict:
    return {
        "bpp": float(np.mean([r["bpp"] for r in rows])),
        "psnr": float(np.mean([r["psnr"] for r in rows])),
        "per_image": rows,
    }


def eval_int_codec(images: List[np.ndarray], net,
                   static_cdfs=None) -> Dict:
    """The bit-exact integer codec, one image at a time: the quality is
    the autoencoder's, the bitstream the lossless-coded latent.  The net
    is fully convolutional, so each padded geometry runs as it is.

    With ``static_cdfs`` (the serving mode) the shipped tables are used and
    containers carry none; otherwise each embeds its image's tables."""
    rows = []
    for img in images:
        padded = _pad_to_16(img)
        x = torch.from_numpy(padded[None].view(np.int8)).to(net.device)
        data = int_codec.compress(net, x, static_cdfs=static_cdfs)
        x_hat, _ = int_codec.decompress(net, data, static_cdfs=static_cdfs)
        recon = x_hat[0, :img.shape[0], :img.shape[1]].cpu().numpy()
        # the int8 output is the low 8 bits: compare as uint8
        rows.append({
            "bpp": 8.0 * len(data) / (img.shape[0] * img.shape[1]),
            "psnr": psnr(img, recon.view(np.uint8)),
        })
    return _summary(rows)


def eval_wavelet_codec(images: List[np.ndarray], profile: str,
                       device=None) -> Dict:
    """The wavelet integer codec under one profile: uint8 in, uint8 out."""
    from .codec.wavelet_codec import WaveletCodec
    codec = WaveletCodec(profile, device=device)
    rows = []
    for img in images:
        padded = _pad_to_16(img)
        blobs = codec.compress_batch(padded[None])
        rec, _ = codec.decompress_batch(blobs)
        recon = rec[0, :img.shape[0], :img.shape[1]]
        rows.append({
            "bpp": 8.0 * len(blobs[0]) / (img.shape[0] * img.shape[1]),
            "psnr": psnr(img, recon),
        })
    return _summary(rows)


def eval_hyper_codec(images: List[np.ndarray], codec) -> Dict:
    """A hyperprior codec in the serial format, one image at a time."""
    rows = []
    for img in images:
        # sides of multiples of 64: g_a downsamples 16x and h_a another
        # 4x, and h_s's 4x upsample must give y's grid exactly
        padded = _pad_to_16(img, mult=64)
        x = torch.from_numpy(padded[None].astype(np.float32) / 255.0)
        data = codec.compress(x.to(codec.device))
        x_hat, _ = codec.decompress(data)
        recon = np.clip(x_hat[0, :img.shape[0], :img.shape[1]].cpu().numpy(),
                        0, 1)
        rows.append({
            "bpp": 8.0 * len(data) / (img.shape[0] * img.shape[1]),
            "psnr": psnr(img / 255.0, recon, peak=1.0),
        })
    return _summary(rows)


def _hyper_codec(name: str, ckpt, device):
    """The hyper codec of ``--codec name`` on a released checkpoint or on
    a training checkpoint's parameters (as the JAX package's
    ``eval_codec``: restored into the templates of a fresh
    ``train.init_state``)."""
    from . import train
    from .codec.hyper_codec import HyperCodec, MeanScaleCodec
    from .utils import train_ckpt
    if ckpt is None:
        raise ValueError(
            f"--codec {name} needs --ckpt: a trained *.params.msgpack "
            f"(checkpoints/hp_scale_* or hp_meanscale_*) or a training "
            f"checkpoint ckpt_*.msgpack; the port has no randomly "
            f"initialised model to evaluate")
    cls = MeanScaleCodec if name == "meanscale" else HyperCodec
    if ckpt.endswith(".params.msgpack"):
        return cls.from_checkpoint(ckpt, device=device)
    cfg = train.TrainConfig(model=name)
    model, opt_state = train.init_state(cfg, device=device)
    _, params, _ = train_ckpt.restore(ckpt, model.state_dict(), opt_state)
    serving = cls.model_cls(cfg.n, cfg.m, device=device)
    serving.load_state_dict(params)
    return cls(serving)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--codec", default="int8",
                    choices=["int8", "hyperprior", "meanscale", "wavelet"])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint of the hyperprior or meanscale codec:"
                         " released (*.params.msgpack) or from training "
                         "(ckpt_*.msgpack)")
    ap.add_argument("--profile", default="haar422",
                    help="wavelet codec profile (codec/wavelet_codec.py)")
    ap.add_argument("--n-synthetic", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    codec = (_hyper_codec(args.codec, args.ckpt, device)
             if args.codec in ("hyperprior", "meanscale") else None)
    if args.data:
        images = [datalib.load_image(p)
                  for p in datalib.list_images(args.data)]
    else:
        images = list(datalib.synthetic_images(args.n_synthetic, 768, 512))

    if args.codec == "int8":
        from .models.codec_int import IntCodecNet
        net = IntCodecNet.from_checkpoint(
            os.path.join(_CKPT_DIR, "reference_weights.npz"), device=device)
        cdfs_path = os.path.join(_CKPT_DIR, "latent_cdfs.npz")
        static_cdfs = (weights_io.load_static_cdfs(cdfs_path)
                       if os.path.exists(cdfs_path) else None)
        res = eval_int_codec(images, net, static_cdfs=static_cdfs)
    elif args.codec == "wavelet":
        res = eval_wavelet_codec(images, args.profile, device=device)
    else:
        res = eval_hyper_codec(images, codec)

    out = {k: v for k, v in res.items() if k != "per_image"}
    out["n_images"] = len(images)
    out["codec"] = args.codec
    print(json.dumps(out))
    return res


if __name__ == "__main__":
    main()
