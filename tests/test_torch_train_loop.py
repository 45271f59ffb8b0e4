"""The port's training loop (``train_loop.py``) on the CPU at full width
(the JAX package's ``train_loop`` has no width flags either; its smoke test
is tests/test_aux.py): a few steps at crop 64 with checkpoints, a resume
that continues the run exactly, and ``--dp 2`` over two gloo ranks against
one process taking the same global batch with the same noise (``--sp``:
tests/test_torch_train_sp.py).

Tolerance of ``--dp 2`` against one process (the same code, summing the
batch's gradient in two halves): after two clip+Adam steps each parameter
within 2e-2 * lr (1e-2 a step) wherever both steps' |g| >= 1e-2 * (leaf
max), and within 4 * lr everywhere.  The one-step tests hold 1e-3 * (leaf
max); here the second update is a ratio of the two steps' moments, and a
gradient summed in halves differs by rounding at ~5e-5 of its leaf's max
(an element at 1.8e-3 of the max moved 0.034 * lr in two steps)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from simple_image_compression_network_tpu_torch import train, train_loop
from simple_image_compression_network_tpu_torch.utils import data, train_ckpt

torch.set_num_threads(1)

BASE = ["--crop", "64", "--batch", "1", "--log-every", "1", "--bank", "1f",
        "--device", "cpu"]


@pytest.mark.parametrize("kind", ["hyperprior", "meanscale", "factorized"])
def test_train_loop_checkpoints_and_resumes_exactly(kind, tmp_path, capsys):
    """2 steps with a checkpoint every 2, then a resume to step 3, equal
    bitwise to 3 steps run straight: each step draws its crops and noise
    from its own seed, and the checkpoint carries the whole state."""
    d = str(tmp_path / "run")
    argv = BASE + ["--model", kind, "--ckpt-dir", d, "--ckpt-every", "2"]
    train_loop.main(argv + ["--steps", "2"])
    assert sorted(os.listdir(d)) == ["ckpt_2.msgpack"]
    capsys.readouterr()
    resumed = train_loop.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert f"resumed from {os.path.join(d, 'ckpt_2.msgpack')} at step 2" in out
    assert "step      3  loss" in out and "step      2  loss" not in out
    assert train_ckpt.latest(d) == os.path.join(d, "ckpt_3.msgpack")
    model, opt = train.init_state(train.TrainConfig(model=kind), 0, "cpu")
    step, saved, opt = train_ckpt.restore(os.path.join(d, "ckpt_3.msgpack"),
                                          model.state_dict(), opt)
    assert step == 3 and opt.count == 3
    assert all(torch.equal(saved[k], v) for k, v in resumed.items())
    straight = train_loop.main(BASE + ["--model", kind, "--steps", "3"])
    for k, v in straight.items():
        assert torch.equal(resumed[k], v), k
        assert torch.isfinite(v).all(), k


def test_train_loop_on_an_image_folder(tmp_path, capsys):
    folder = tmp_path / "images"
    folder.mkdir()
    for i, img in enumerate(data.synthetic_images(2, 96, 80, seed=4)):
        Image.fromarray(img).save(folder / f"im{i}.png")
    train_loop.main(BASE + ["--model", "factorized", "--steps", "1",
                            "--data", str(folder)])
    assert "step      1  loss" in capsys.readouterr().out


def test_dp2_equals_one_process_on_the_global_batch(capsys):
    """Two gloo CPU ranks at B = 1 each (one bounded spawn; ``main``
    raises unless both end with bitwise-equal parameters) against one
    process stepping the two ranks' crops as one batch of 2 with the same
    noise."""
    steps, lr = 2, train.TrainConfig().lr
    got = train_loop.main(["--dp", "2", "--batch", "2", "--steps",
                           str(steps)] + BASE[:2] + BASE[4:])
    out = capsys.readouterr().out
    assert "rank 0 of 2 (gloo)" in out and "rank 1 of 2 (gloo)" in out

    cfg = train.TrainConfig(crop=64, batch=2)
    model, opt = train.init_state(cfg, 0, "cpu")
    seen = []

    def keep(grads, metrics):
        seen.append([g.abs() for g in grads])
        return grads, metrics
    step_fn = train.make_train_step(cfg, model, grad_mean=keep)
    images = data.synthetic_images(16, 512, 512, seed=0)
    rngs = [np.random.default_rng(r * 1_000_003) for r in range(2)]
    gen = torch.Generator()
    for step in range(steps):
        batch = np.concatenate([data.random_crops(images, 64, 1, rng)
                                for rng in rngs])
        noise = model.noise_like(batch.shape,
                                 train.step_generator(gen, 0, step))
        step_fn(opt, torch.from_numpy(batch), noise)
    names = [k for k, _ in model.named_parameters()]
    want = model.state_dict()
    assert set(got) == set(want)
    for i, k in enumerate(names):
        big = torch.ones_like(want[k], dtype=torch.bool)
        for g in seen:
            big &= g[i] >= 1e-2 * g[i].max()
        diff = (got[k] - want[k]).abs()
        assert diff.max() <= 2 * steps * lr, k
        assert (diff[big] <= 1e-2 * steps * lr).all(), (k, diff[big].max())
