"""``train_loop --sp``: the crop's X axis over ranks, with halos whose
backward carries the gradients back (``parallel/spatial.halo_exchange_grad``),
on the CPU over gloo.

One bounded spawn of two ranks runs every case (the ranks import this
module, so it imports no JAX): the differentiable halo through the
hyperprior's tile layers against autograd on the whole tensor, and
``train_loop``'s rank at ``--sp 2`` for the factorized model at crop 64 and
the scale hyperprior at crop 128 (one row of z a rank).  Each is held
against one process stepping the same crops with the same noise; the
``initialize_multihost`` start (two processes given ``MASTER_ADDR``,
``WORLD_SIZE`` and ``RANK``) against the spawned ranks.

Tolerances: the halo's gradients (tile input, and each layer's parameters
summed over the ranks) within 1e-5 of the whole tensor's leaf max (float32
sums in other orders); ``--sp 2`` against one process, the ``--dp`` test's
tolerance: after two clip+Adam steps each parameter within 2e-2 * lr where
both steps' |g| >= 1e-2 * (leaf max), within 4 * lr everywhere, and the
last step's loss, bpp, MSE and PSNR within 1e-5 relative; the launched
ranks against the spawned ones: bitwise."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from simple_image_compression_network_tpu_torch import train, train_loop
from simple_image_compression_network_tpu_torch.models import hyperprior
from simple_image_compression_network_tpu_torch.parallel import (
    distributed, hyper_sharded, mesh as meshlib, spatial)
from simple_image_compression_network_tpu_torch.utils import data, train_ckpt

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STEPS = 2
CASES = {"factorized": 64, "hyperprior": 128}
HALO_TOL = 1e-5
METRIC_RTOL = 1e-5
SPAWN_S = 300


def _argv(kind: str, crop: int) -> list:
    return ["--model", kind, "--crop", str(crop), "--batch", "1", "--steps",
            str(STEPS), "--log-every", "1", "--bank", "1f", "--device",
            "cpu"]


def _halo_layers():
    layers = [hyperprior._conv(4, 6), hyperprior._Deconv(6, 5),
              hyperprior._conv(5, 3, k=3, s=1)]
    for layer in layers:
        layer.reset_parameters(torch.Generator().manual_seed(1))
        layer.requires_grad_(True)
    x = torch.randn((2, 4, 32, 12),
                    generator=torch.Generator().manual_seed(2))
    r = torch.randn((2, 3, 32, 12),
                    generator=torch.Generator().manual_seed(3))
    return layers, x, r


def _halo_chain(layers, x, r, conv) -> torch.Tensor:
    h = x
    for layer in layers:
        h = conv(layer, h)
    return torch.sum(h * r)


def _halo_case(mesh) -> dict:
    """This rank's tile gradients and its parameters' gradients (not yet
    summed) through the tiled layers."""
    layers, x, r = _halo_layers()
    k, n = mesh.coord("x"), mesh.size("x")
    tile = train_loop._cut(x, 2, k, n).clone().requires_grad_(True)
    loss = _halo_chain(layers, tile, train_loop._cut(r, 2, k, n),
                       hyper_sharded._tiled(mesh, "x"))
    params = [p for layer in layers for p in layer.parameters()]
    grads = torch.autograd.grad(loss, [tile] + params)
    return {"x": grads[0].numpy(), "params": [g.numpy() for g in grads[1:]]}


def _ranks() -> dict:
    """Every case on one rank of the spawned pair."""
    mesh = meshlib.make_mesh((1, 2), ("data", "x"), "cpu")
    out = {"halo": _halo_case(mesh), "staged": spatial.halo_exchange
           .staged_bytes}
    for kind, crop in CASES.items():
        args = train_loop._parse(_argv(kind, crop) + ["--sp", "2"])
        args.dp = 1
        out[kind] = train_loop._rank(args, "cpu")
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def ranks():
    return distributed.spawn_ranks(_ranks, 2, backend="gloo", device="cpu",
                                   timeout_s=SPAWN_S)


def test_halo_gradients_equal_autograd_on_the_whole_tensor(ranks):
    layers, x, r = _halo_layers()
    x = x.clone().requires_grad_(True)
    loss = _halo_chain(layers, x, r, hyperprior._whole)
    params = [p for layer in layers for p in layer.parameters()]
    want = torch.autograd.grad(loss, [x] + params)
    assert [res["staged"] for res in ranks] == [0, 0]   # host tensors
    got_x = np.concatenate([res["halo"]["x"] for res in ranks], axis=2)
    scale = float(want[0].abs().max())
    assert np.abs(got_x - want[0].numpy()).max() <= HALO_TOL * scale
    for i, w in enumerate(want[1:]):
        got = sum(res["halo"]["params"][i] for res in ranks)
        assert (np.abs(got - w.numpy()).max()
                <= HALO_TOL * float(w.abs().max())), i


def _one_process(kind: str, crop: int):
    """One process stepping the crops of data index 0 (seed 0) with the
    step's noise: the state ``--sp 2`` must reach."""
    cfg = train.TrainConfig(model=kind, crop=crop, batch=1)
    model, opt = train.init_state(cfg, 0, "cpu")
    seen = []

    def keep(grads, metrics):
        seen.append([g.abs() for g in grads])
        return grads, metrics
    step_fn = train.make_train_step(cfg, model, grad_mean=keep)
    images = data.synthetic_images(16, 512, 512, seed=0)
    rng = np.random.default_rng(0)
    gen = torch.Generator()
    for step in range(STEPS):
        batch = data.random_crops(images, crop, 1, rng)
        noise = model.noise_like(batch.shape,
                                 train.step_generator(gen, 0, step))
        metrics = step_fn(opt, torch.from_numpy(batch), noise)
    return model, seen, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("kind", list(CASES))
def test_sp2_equals_one_process_on_the_same_batch(ranks, kind):
    first = ranks[0][kind]["params"]
    for res in ranks[1:]:
        for k, v in res[kind]["params"].items():
            assert np.array_equal(first[k], v), k
    lr = train.TrainConfig().lr
    model, seen, metrics = _one_process(kind, CASES[kind])
    # the last step's loss: the ranks' shares summed (global bits and
    # squared error over the whole crop's pixels)
    for k, v in metrics.items():
        got = ranks[0][kind]["metrics"][k]
        assert abs(got - v) <= METRIC_RTOL * abs(v), (k, got, v)
    want = model.state_dict()
    assert set(first) == set(want)
    for i, (k, _) in enumerate(model.named_parameters()):
        big = torch.ones_like(want[k], dtype=torch.bool)
        for g in seen:
            big &= g[i] >= 1e-2 * g[i].max()
        diff = (torch.from_numpy(first[k]) - want[k]).abs()
        assert diff.max() <= 2 * STEPS * lr, k
        assert (diff[big] <= 1e-2 * STEPS * lr).all(), (k, diff[big].max())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launched_ranks_equal_the_spawned_ones(ranks, tmp_path):
    """``--dp 1 --sp 2`` as two processes a launcher started
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``): ``main`` runs each as its
    rank, and rank 0's checkpoint holds the spawned ranks' parameters."""
    ckpt = str(tmp_path / "run")
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m",
           "simple_image_compression_network_tpu_torch.train_loop",
           "--dp", "1", "--sp", "2", "--ckpt-dir", ckpt] + _argv(
               "factorized", CASES["factorized"])
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=SPAWN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert f"step      {STEPS}  loss" in outs[0]
    model, opt = train.init_state(train.TrainConfig(model="factorized"), 0,
                                  "cpu")
    step, saved, _ = train_ckpt.restore(train_ckpt.latest(ckpt),
                                        model.state_dict(), opt)
    assert step == STEPS
    for k, v in ranks[0]["factorized"]["params"].items():
        assert torch.equal(saved[k], torch.from_numpy(v)), k


@pytest.mark.parametrize("kind,crop,sp", [("hyperprior", 64, 2),
                                          ("meanscale", 192, 2),
                                          ("factorized", 48, 2)])
def test_sp_refuses_tiles_without_a_whole_latent_row(kind, crop, sp):
    with pytest.raises(ValueError, match="whole latent row"):
        train_loop.main(_argv(kind, crop) + ["--sp", str(sp)])


@pytest.mark.parametrize("env,gpus,want", [
    # torchrun over 2 hosts of 8 cards: a card a rank on each host
    ({"WORLD_SIZE": "16", "RANK": "11", "LOCAL_WORLD_SIZE": "8",
      "LOCAL_RANK": "3"}, 8, ("nccl", 3)),
    # the same ranks on hosts of 4 cards: two ranks a card
    ({"WORLD_SIZE": "16", "RANK": "11", "LOCAL_WORLD_SIZE": "8",
      "LOCAL_RANK": "3"}, 4, ("gloo", 3)),
    # one host, no local names: the global rank is the local one
    ({"WORLD_SIZE": "2", "RANK": "1"}, 2, ("nccl", 1)),
    ({"WORLD_SIZE": "2", "RANK": "1"}, 1, ("gloo", 0)),
    # the host's CPU
    ({"WORLD_SIZE": "16", "RANK": "11", "LOCAL_WORLD_SIZE": "8",
      "LOCAL_RANK": "3"}, 0, ("gloo", None)),
])
def test_launched_backend_follows_the_local_layout(monkeypatch, env, gpus,
                                                   want):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert train_loop._launch_layout(gpus) == want
