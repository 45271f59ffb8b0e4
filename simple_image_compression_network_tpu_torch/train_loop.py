"""The training loop: RD training of the float codecs with checkpoint/resume.

The port of the JAX package's ``train_loop.py``.  Usage:

    python -m simple_image_compression_network_tpu_torch.train_loop \\
        --steps 1000 --crop 256 --batch 8 --rd-lambda 0.01 \\
        [--model hyperprior|meanscale|factorized] [--data /path/to/images] \\
        [--ckpt-dir runs/hp01] [--dp N] [--device cpu]

Without --data it trains on the mixed synthetic bank
(``utils/data.training_bank``).  Runs on the card unless ``--device`` names
another device.  With --ckpt-dir it resumes from the directory's latest
checkpoint and saves one every --ckpt-every steps and at the end, in the
JAX package's format (either package resumes the other's).

* One device (``--dp`` 1, or 0 with one card): blocks of --log-every steps,
  the crops drawn on the device from the bank held there, one read of the
  metrics a block (``train.make_train_block``).
* ``--dp N > 1``: N ranks (``parallel/distributed.spawn_ranks``; NCCL with a
  card a rank, else gloo), each taking its share of the batch from host
  crops seeded by its rank, as the JAX package's processes do; the
  gradients are averaged over the ranks in one all-reduce a step before
  the clip, so every rank applies the same update, and rank 0 saves.
* ``--sp > 1`` (the crop's X axis over ranks, whose halos must carry
  gradients back) is not ported.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from . import train
from .parallel import distributed
from .utils import data as datalib
from .utils import train_ckpt
from .utils.device import resolve_device

# a data-parallel run's bound: set-up (spawn, bank, build), then each step
RANKS_SETUP_S = 300.0
RANKS_STEP_S = 60.0


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="hyperprior",
                    choices=["hyperprior", "meanscale", "factorized"])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--rd-lambda", type=float, default=0.01, dest="rd_lambda")
    ap.add_argument("--data", default=None,
                    help="image folder (else synthetic)")
    ap.add_argument("--bank", default="mixed", choices=["mixed", "1f"],
                    help="synthetic bank when --data is unset: 'mixed' = "
                    "photos+noise+edges+textures (utils.data.training_bank),"
                    " '1f' = plain 1/f noise")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (0 = one a card, 1 on the CPU)")
    ap.add_argument("--sp", type=int, default=1,
                    help="spatial ranks over the crop's X (not ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def _config(args) -> train.TrainConfig:
    return train.TrainConfig(model=args.model, rd_lambda=args.rd_lambda,
                             lr=args.lr, crop=args.crop, batch=args.batch)


def _images(args) -> np.ndarray:
    if args.data:
        return np.stack([datalib.load_image(p)
                         for p in datalib.list_images(args.data)])
    if args.bank == "mixed":
        return datalib.training_bank(48, 512, 512, seed=args.seed)
    return datalib.synthetic_images(16, 512, 512, seed=args.seed)


def _start(args, cfg, device):
    """(model, opt_state, first step): a fresh init, or the latest
    checkpoint of --ckpt-dir restored into it."""
    model, opt_state = train.init_state(cfg, args.seed, device)
    start = 0
    last = train_ckpt.latest(args.ckpt_dir) if args.ckpt_dir else None
    if last:
        start, params, opt_state = train_ckpt.restore(
            last, model.state_dict(), opt_state)
        model.load_state_dict(params)
        if distributed.is_primary():
            print(f"resumed from {last} at step {start}", flush=True)
    return model, opt_state, start


def _log(step: int, m: Dict[str, float], rate: float) -> None:
    print(f"step {step:6d}  loss {m['loss']:.4f}  bpp {m['bpp']:.4f}  "
          f"psnr {m['psnr']:.2f}  ({rate:.2f} steps/s)", flush=True)


def _save(args, step: int, model, opt_state) -> None:
    train_ckpt.save(os.path.join(args.ckpt_dir, f"ckpt_{step}.msgpack"),
                    step, model.state_dict(), opt_state)


def _host_state(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in
            model.state_dict().items()}


def _single(args, cfg, device) -> Dict[str, torch.Tensor]:
    """One device: blocks of --log-every steps with crops and noise drawn
    on the device; one read of the metrics a block."""
    model, opt_state, step = _start(args, cfg, device)
    block = train.make_train_block(cfg, model)
    bank = torch.from_numpy(_images(args)).to(device)
    t0 = time.perf_counter()
    while step < args.steps:
        n = min(args.log_every, args.steps - step)
        m = block(opt_state, bank, args.seed, step, n)
        m = dict(zip(m, torch.stack(list(m.values())).tolist()))
        step += n
        rate = n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        _log(step, m, rate)
        if args.ckpt_dir and step % args.ckpt_every < n:
            _save(args, step, model, opt_state)
    if args.ckpt_dir:
        _save(args, args.steps, model, opt_state)
    return model.state_dict()


def _grad_mean(grads: List[torch.Tensor], metrics: Dict[str, torch.Tensor]):
    """The ranks' means of the gradients and metrics: one all-reduce of
    one flat buffer, staged through host memory where the backend (gloo)
    moves host tensors only."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack(list(metrics.values()))])
    staged = flat.is_cuda and dist.get_backend() == "gloo"
    buf = flat.cpu() if staged else flat
    dist.all_reduce(buf)
    if staged:
        flat.copy_(buf)
    flat /= dist.get_world_size()
    out = list(torch.split(flat, [g.numel() for g in grads]
                           + [len(metrics)]))
    return ([o.view_as(g) for o, g in zip(out, grads)],
            dict(zip(metrics, out[-1])))


def _dp_rank(args: argparse.Namespace, device: str) -> dict:
    """One rank of ``--dp N``: the JAX package's multi-process input (host
    crops from ``default_rng(seed + start + rank * 1_000_003)``, the rank's
    share of the batch) and noise, the step's draw for the whole batch cut
    to the rank's share, so the ranks together take the step one process
    would take on the whole batch.  Returns the rank's parameters and
    host ms a step."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} does not divide over "
                         f"{world} ranks")
    local = args.batch // world
    device = torch.device(device)
    if device.type == "cuda":       # the card spawn_ranks gave this rank
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = _config(args)
    model, opt_state, start = _start(args, cfg, device)
    step_fn = train.make_train_step(cfg, model, grad_mean=_grad_mean)
    images = _images(args)
    rng = np.random.default_rng(args.seed + start + rank * 1_000_003)
    gen = torch.Generator(device=device)
    shape = (args.batch, args.crop, args.crop, 3)
    ms: List[float] = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = torch.from_numpy(datalib.random_crops(
            images, args.crop, local, rng)).to(device)
        noise = {k: v[rank * local:(rank + 1) * local] for k, v in
                 model.noise_like(shape, train.step_generator(
                     gen, args.seed, step)).items()}
        metrics = step_fn(opt_state, batch, noise)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t_step) * 1e3)
        if (step + 1) % args.log_every == 0 and rank == 0:
            rate = args.log_every / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            _log(step + 1, dict(zip(metrics, torch.stack(
                list(metrics.values())).tolist())), rate)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0 and rank == 0:
            _save(args, step + 1, model, opt_state)
    if args.ckpt_dir and rank == 0:
        _save(args, args.steps, model, opt_state)
    return {"params": _host_state(model), "ms": ms}


def _data_parallel(args, device) -> Dict[str, torch.Tensor]:
    n = args.dp
    backend = ("nccl" if device.type == "cuda"
               and n <= torch.cuda.device_count() else "gloo")
    ranks = distributed.spawn_ranks(
        _dp_rank, n, backend=backend, device=device,
        timeout_s=RANKS_SETUP_S + RANKS_STEP_S * args.steps,
        args=(args, str(device)))
    first = ranks[0]["params"]
    for r, res in enumerate(ranks):
        if any(not np.array_equal(first[k], v)
               for k, v in res["params"].items()):
            raise RuntimeError(f"rank {r} of {n} ended with parameters "
                               f"other than rank 0's")
        if res["ms"]:
            print(f"rank {r} of {n} ({backend}): "
                  f"{float(np.median(res['ms'])):.3f} ms a step (median of "
                  f"{len(res['ms'])})", flush=True)
    return {k: torch.from_numpy(v) for k, v in first.items()}


def main(argv=None) -> Dict[str, torch.Tensor]:
    """Train; returns the trained parameters as a ``state_dict`` (on the
    training device; on the host from ``--dp N > 1``)."""
    args = _parse(argv)
    if args.sp > 1:
        raise NotImplementedError(
            "--sp > 1 (the crop's X axis over ranks, halos carrying "
            "gradients back) is not ported: ROADMAP queue 1 item 6d")
    device = resolve_device(args.device)
    dp = args.dp or (torch.cuda.device_count() if device.type == "cuda"
                     else 1)
    if dp > 1:
        args.dp = dp
        return _data_parallel(args, device)
    return _single(args, _config(args), device)


if __name__ == "__main__":
    main()
