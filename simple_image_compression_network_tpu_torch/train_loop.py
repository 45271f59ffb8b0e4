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
* ``--dp N``, ``--sp M`` with N * M > 1: a (dp, sp) grid of ranks
  (``parallel/distributed.spawn_ranks``; NCCL with a card a rank, else
  gloo), or, when a launcher started one process a rank (``MASTER_ADDR``,
  ``WORLD_SIZE``, ``RANK``), this process as its rank.  The batch is cut
  over dp, each group taking its share from host crops seeded by its data
  index, as the JAX package's processes do; the crop's X axis is cut over
  sp, each conv on a rank's rows with halos whose backward carries the
  gradients back to their owners (JAX's GSPMD makes both).  The gradients
  are summed over sp and averaged over dp in one all-reduce a step before
  the clip, so every rank applies the update one process would make on
  the whole batch, and rank 0 saves.
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
from .parallel import distributed, hyper_sharded
from .parallel import mesh as meshlib
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
                    help="data-parallel ranks (0 = max(1, n_dev // sp), "
                    "n_dev the cards, 1 on the CPU)")
    ap.add_argument("--sp", type=int, default=1,
                    help="spatial ranks over the crop's X")
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


def _sp_tile(cfg: train.TrainConfig, sp: int) -> None:
    """Refuse a crop whose X does not cut into ``sp`` tiles of whole
    latent rows: each rank needs at least one row of z (crop / 64 rows)
    in a hyperprior, of y (crop / 16) in the factorized model."""
    side = 16 if cfg.model == "factorized" else 64
    if cfg.crop % (side * sp):
        raise ValueError(
            f"--sp {sp} cuts the crop's {cfg.crop} rows into tiles of "
            f"{cfg.crop / sp:g}: the {cfg.model} model needs a multiple of "
            f"{side} a rank (a whole latent row each)")


def _reduce(dp: int):
    """``grad_mean`` of a (dp, sp) rank: the gradients and the loss's
    pieces summed over every rank in one all-reduce of one flat buffer
    (staged through host memory where the backend, gloo, moves host
    tensors only), then divided by ``dp``: a sum over the spatial ranks,
    whose pieces add up to their group's loss, and a mean over the
    data-parallel groups.  PSNR from the reduced MSE, as JAX takes it
    from the global batch's."""
    def reduce(grads: List[torch.Tensor], metrics: Dict[str, torch.Tensor]):
        names = [k for k in metrics if k != "psnr"]
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [torch.stack([metrics[k] for k in names])])
        staged = flat.is_cuda and dist.get_backend() == "gloo"
        buf = flat.cpu() if staged else flat
        dist.all_reduce(buf)
        if staged:
            flat.copy_(buf)
        flat /= dp
        out = list(torch.split(flat, [g.numel() for g in grads]
                               + [len(names)]))
        m = dict(zip(names, out[-1]))
        m["psnr"] = -10.0 * torch.log10(torch.clamp(m["mse"], min=1e-12))
        return [o.view_as(g) for o, g in zip(out, grads)], m
    return reduce


def _tile_loss(cfg: train.TrainConfig, mesh, num_pixels: int):
    """A spatial rank's share of its group's RD loss: the tile's bits and
    squared error over the group batch's pixel count (B X Y, the whole
    crop), each conv on the tile with its halos
    (``hyper_sharded._tiled``), so the shares sum to the loss of the
    whole crop."""
    conv = hyper_sharded._tiled(mesh, "x")

    def loss_fn(model, tile: torch.Tensor, noise: Dict):
        out = model(tile, noise=noise, conv=conv)
        bpp = out["bits"] / num_pixels
        mse = torch.sum(torch.square(out["x_hat"] - tile)) / (
            3 * num_pixels)
        loss = bpp + cfg.rd_lambda * (255.0 ** 2) * mse
        return loss, {"loss": loss, "bpp": bpp, "mse": mse}
    return loss_fn


def _cut(t: torch.Tensor, dim: int, k: int, n: int) -> torch.Tensor:
    """Slice k of n equal slices of ``t`` along ``dim``."""
    size = t.shape[dim] // n
    return t.narrow(dim, k * size, size)


def _rank(args: argparse.Namespace, device: str) -> dict:
    """One rank of a (dp, sp) grid (rank = data index * sp + x index).

    * Input: the JAX package's multi-process pipeline, host crops from
      ``default_rng(seed + start + d * 1_000_003)`` for data index d, so
      the sp ranks of one group take the same crops, the group's share of
      the batch; a rank keeps its X rows of them.
    * Noise: the step's draw for the whole batch, cut to the group's
      images and the rank's rows of y and z.
    * Step: with sp > 1 each conv runs on the tile with halos that carry
      gradients back (``_tile_loss``); the gradients are summed over sp and
      averaged over dp (``_reduce``), so every rank applies the update one
      process would make on the whole batch.  Rank 0 saves.

    Returns the rank's parameters, host ms a step and last metrics."""
    world = dist.get_world_size()
    sp = args.sp
    dp = world // sp
    if args.batch % dp:
        raise ValueError(f"--batch {args.batch} does not divide over "
                         f"{dp} data-parallel ranks")
    cfg = _config(args)
    device = torch.device(device)
    if device.type == "cuda":       # the card this rank was given
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = meshlib.make_mesh((dp, sp), ("data", "x"), device)
    d, x = mesh.coord("data"), mesh.coord("x")
    local = args.batch // dp
    model, opt_state, start = _start(args, cfg, device)
    loss_fn = (_tile_loss(cfg, mesh, local * cfg.crop * cfg.crop)
               if sp > 1 else None)
    step_fn = train.make_train_step(cfg, model, grad_mean=_reduce(dp),
                                    loss_fn=loss_fn)
    images = _images(args)
    rng = np.random.default_rng(args.seed + start + d * 1_000_003)
    gen = torch.Generator(device=device)
    shape = (args.batch, args.crop, args.crop, 3)
    ms: List[float] = []
    metrics: Dict[str, torch.Tensor] = {}
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        crops = datalib.random_crops(images, args.crop, local, rng)
        batch = _cut(torch.from_numpy(crops), 1, x, sp).to(device)
        noise = {k: _cut(v[d * local:(d + 1) * local], 2, x, sp)
                 for k, v in model.noise_like(shape, train.step_generator(
                     gen, args.seed, step)).items()}
        metrics = step_fn(opt_state, batch, noise)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t_step) * 1e3)
        if (step + 1) % args.log_every == 0 and mesh.rank == 0:
            rate = args.log_every / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            _log(step + 1, dict(zip(metrics, torch.stack(
                list(metrics.values())).tolist())), rate)
        if (args.ckpt_dir and (step + 1) % args.ckpt_every == 0
                and mesh.rank == 0):
            _save(args, step + 1, model, opt_state)
    if args.ckpt_dir and mesh.rank == 0:
        _save(args, args.steps, model, opt_state)
    return {"params": _host_state(model), "ms": ms,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _same_params(ranks: List[dict], tag: str) -> Dict[str, torch.Tensor]:
    """Rank 0's parameters, once every rank's are bitwise equal to them;
    prints each rank's median ms a step."""
    first = ranks[0]["params"]
    for r, res in enumerate(ranks):
        if any(not np.array_equal(first[k], v)
               for k, v in res["params"].items()):
            raise RuntimeError(f"rank {r} of {len(ranks)} ended with "
                               f"parameters other than rank 0's")
        if res["ms"]:
            print(f"rank {r} of {len(ranks)} ({tag}): "
                  f"{float(np.median(res['ms'])):.3f} ms a step (median of "
                  f"{len(res['ms'])})", flush=True)
    return {k: torch.from_numpy(v) for k, v in first.items()}


def _spawned(args, device) -> Dict[str, torch.Tensor]:
    """``dp * sp`` ranks started here (``spawn_ranks``): NCCL with a card
    a rank, else gloo."""
    n = args.dp * args.sp
    backend = ("nccl" if device.type == "cuda"
               and n <= torch.cuda.device_count() else "gloo")
    ranks = distributed.spawn_ranks(
        _rank, n, backend=backend, device=device,
        timeout_s=RANKS_SETUP_S + RANKS_STEP_S * args.steps,
        args=(args, str(device)))
    return _same_params(ranks, backend)


def _launch_layout(gpus: int) -> tuple:
    """(backend, card) of a rank a launcher started, from its place on its
    host: ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (torchrun's), else
    ``RANK`` and ``WORLD_SIZE`` (a launch on one host).  NCCL when every
    rank of the host has a card of its own, else gloo; the card is the
    local rank's (ranks share cards round robin), None without cards."""
    world = os.environ.get("WORLD_SIZE", "1")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK",
                                    os.environ.get("RANK", "0")))
    if not gpus:
        return "gloo", None
    return ("nccl" if local_world <= gpus else "gloo"), local_rank % gpus


def _launched(args, device) -> Dict[str, torch.Tensor]:
    """This process is one rank of a group a launcher started
    (``initialize_multihost`` has joined it): run the rank here.  Every
    rank returns the same parameters."""
    try:
        res = _rank(args, str(device))
    finally:
        dist.destroy_process_group()
    return {k: torch.from_numpy(v) for k, v in res["params"].items()}


def main(argv=None) -> Dict[str, torch.Tensor]:
    """Train; returns the trained parameters as a ``state_dict`` (on the
    training device; on the host from a run over ranks).

    ``dp`` defaults to the JAX package's ``max(1, n_dev // sp)``: n_dev
    the ranks of a launched group (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``, read by ``distributed.initialize_multihost``), else the
    cards (1 on the CPU)."""
    args = _parse(argv)
    device = resolve_device(args.device)
    if args.sp < 1:
        raise ValueError(f"--sp {args.sp}")
    if args.sp > 1:
        _sp_tile(_config(args), args.sp)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    launched = bool(os.environ.get("MASTER_ADDR"))
    if launched:
        n_dev = world
    else:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    args.dp = args.dp or max(1, n_dev // args.sp)
    if launched:
        if args.dp * args.sp != world:
            raise ValueError(f"--dp {args.dp} x --sp {args.sp} ranks in a "
                             f"group of {world}")
        backend, card = _launch_layout(
            torch.cuda.device_count() if device.type == "cuda" else 0)
        if card is not None:
            torch.cuda.set_device(card)
        distributed.initialize_multihost(init_timeout=RANKS_SETUP_S,
                                         backend=backend)
        return _launched(args, device)
    if args.dp * args.sp > 1:
        return _spawned(args, device)
    return _single(args, _config(args), device)


if __name__ == "__main__":
    main()
