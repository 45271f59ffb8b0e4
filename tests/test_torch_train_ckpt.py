"""The port's training checkpoints (``utils/train_ckpt.py``, the msgpack
writer of ``utils/msgpack_io.py``, ``weights_io.hyper_params_to_jax``)
against the JAX package's: files cross both ways with equal leaves, the
in-repo ``checkpoints/hp_scale_l0.01/ckpt_10000.msgpack`` (read once for
the module) is restored bitwise and written back to its own bytes,
``restore`` refuses what does not fit its templates, ``eval_codec --ckpt``
on a training checkpoint prints the JAX package's digits, and the z tables
built from a training checkpoint equal the JAX package's."""

import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from flax.core import unfreeze
from PIL import Image

from simple_image_compression_network_tpu import eval_codec as j_eval
from simple_image_compression_network_tpu import train as j_train
from simple_image_compression_network_tpu.codec import hyper_codec as j_hc
from simple_image_compression_network_tpu.utils import train_ckpt as j_ckpt
from simple_image_compression_network_tpu_torch import eval_codec, train
from simple_image_compression_network_tpu_torch.codec import hyper_codec
from simple_image_compression_network_tpu_torch.utils import (
    data, msgpack_io, train_ckpt, weights_io)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT_DIR = os.path.join(ROOT, "checkpoints")
TRAIN_CKPT = os.path.join(CKPT_DIR, "hp_scale_l0.01", "ckpt_10000.msgpack")
RELEASED = {"hyperprior": os.path.join(CKPT_DIR,
                                       "hp_scale_l0.01.params.msgpack"),
            "meanscale": os.path.join(CKPT_DIR,
                                      "hp_meanscale_l0.01.params.msgpack")}
N, M = 16, 24


@pytest.fixture(scope="module")
def ckpt_10000():
    """The JAX package's training checkpoint: its bytes and flax's tree."""
    with open(TRAIN_CKPT, "rb") as f:
        raw = f.read()
    return raw, serialization.msgpack_restore(raw)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _assert_same(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k, v in la.items():
        w = np.asarray(lb[k])
        assert np.asarray(v).dtype == w.dtype and np.shape(v) == w.shape, k
        np.testing.assert_array_equal(np.asarray(v), w, err_msg=k)


# ---------------------------------------------------------------------------
# The msgpack writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["train", "params"])
def test_writer_gives_back_the_files_bytes(name, ckpt_10000):
    if name == "train":
        raw = ckpt_10000[0]
    else:
        with open(RELEASED["hyperprior"], "rb") as f:
            raw = f.read()
    assert msgpack_io.dumps(msgpack_io.loads(raw)) == raw


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -129,
    -40000, -2 ** 31 - 1, "", "k" * 31, "k" * 32, "k" * 300, b"ab",
    b"x" * 70000, [1] * 15, [1] * 16, {f"k{i}": i for i in range(16)}],
    ids=lambda v: repr(v)[:12])
def test_writer_forms_match_msgpack(value):
    """Each value in the smallest form, as the msgpack package packs it,
    and read back."""
    got = msgpack_io.dumps(value)
    assert got == msgpack.packb(value)
    assert msgpack_io.loads(got) == value


@pytest.mark.parametrize("arr", [np.zeros((), np.int32),
                                 np.arange(3, dtype=np.int8),
                                 np.ones((2, 3), np.float32),
                                 np.zeros((1,), np.uint8)],
                         ids=["i32-scalar", "i8-3", "f32-2x3", "u8-1"])
def test_writer_ndarrays_match_flax(arr):
    """ndarray leaves as flax writes them (ext 1; fixext where the record
    is 1, 2, 4, 8 or 16 bytes)."""
    tree = {"a": arr}
    got = msgpack_io.dumps(tree)
    assert got == serialization.msgpack_serialize(tree)
    back = msgpack_io.loads(got)["a"]
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)


def test_writer_refuses_what_a_checkpoint_does_not_hold():
    for bad in (1.5, None, True, {1: 2}):
        with pytest.raises(TypeError):
            msgpack_io.dumps(bad)


# ---------------------------------------------------------------------------
# train_ckpt both ways
# ---------------------------------------------------------------------------

def test_hyper_params_to_jax_inverts_from_jax():
    variables = weights_io.load_hyper_checkpoint(RELEASED["meanscale"])
    back = weights_io.hyper_params_to_jax(
        weights_io.hyper_params_from_jax(variables))
    _assert_same(back, {"params": variables["params"]})
    assert list(back["params"]) == sorted(back["params"])


@pytest.mark.parametrize("kind", ["hyperprior", "meanscale", "factorized"])
def test_port_checkpoint_restores_in_jax(kind, tmp_path):
    """A file the port writes after a step restores in JAX's
    ``train_ckpt.restore`` into ``train.init_state``'s templates, with
    the port's leaves."""
    cfg = train.TrainConfig(model=kind, n=N, m=M, crop=64, batch=1)
    model, opt = train.init_state(cfg, 1, "cpu")
    x = torch.from_numpy(data.synthetic_images(1, 64, 64, seed=2)) / 255.0
    train.make_train_step(cfg, model)(
        opt, x.float(), model.noise_like(x.shape, torch.Generator()))
    path = str(tmp_path / "ckpt_1.msgpack")
    train_ckpt.save(path, 1, model.state_dict(), opt)
    cfg_j = j_train.TrainConfig(model=kind, n=N, m=M, crop=64, batch=1)
    _, params_j, opt_j = j_train.init_state(cfg_j, jax.random.key(0))
    step, params_r, opt_r = j_ckpt.restore(path, params_j, opt_j)
    assert step == 1
    _assert_same(jax.tree_util.tree_map(np.asarray, unfreeze(params_r)),
                 weights_io.hyper_params_to_jax(model.state_dict()))
    adam = opt_r[1][0]
    assert int(adam.count) == 1
    _assert_same(jax.tree_util.tree_map(np.asarray, unfreeze(adam.mu)),
                 weights_io.hyper_params_to_jax(opt.mu))
    _assert_same(jax.tree_util.tree_map(np.asarray, unfreeze(adam.nu)),
                 weights_io.hyper_params_to_jax(opt.nu))


def test_jax_checkpoint_restores_in_port(ckpt_10000, tmp_path):
    """``ckpt_10000.msgpack`` (written by the JAX package's train_loop)
    restores with bitwise-equal leaves, and saving it again gives the
    file's bytes; a small JAX-written mean-scale file too."""
    raw, tree = ckpt_10000
    model, opt = train.init_state(train.TrainConfig(), 0, "cpu")
    step, params, opt_r = train_ckpt.restore(TRAIN_CKPT, model.state_dict(),
                                             opt)
    assert step == 10000 and opt_r.count == 10000
    _assert_same(weights_io.hyper_params_to_jax(params), tree["params"])
    adam = tree["opt_state"]["1"]["0"]
    _assert_same(weights_io.hyper_params_to_jax(opt_r.mu), adam["mu"])
    _assert_same(weights_io.hyper_params_to_jax(opt_r.nu), adam["nu"])
    path = str(tmp_path / "again.msgpack")
    train_ckpt.save(path, step, params, opt_r)
    with open(path, "rb") as f:
        assert f.read() == raw

    cfg_j = j_train.TrainConfig(model="meanscale", n=N, m=M)
    _, params_j, opt_j = j_train.init_state(cfg_j, jax.random.key(3),
                                            input_shape=(1, 64, 64, 3))
    small = str(tmp_path / "ckpt_3.msgpack")
    j_ckpt.save(small, 3, params_j, opt_j)
    model, opt = train.init_state(train.TrainConfig(
        model="meanscale", n=N, m=M), 0, "cpu")
    step, params, opt_r = train_ckpt.restore(small, model.state_dict(), opt)
    assert step == 3 and opt_r.count == 0
    _assert_same(weights_io.hyper_params_to_jax(params),
                 jax.tree_util.tree_map(np.asarray, unfreeze(params_j)))


def _small_file(tmp_path):
    cfg = train.TrainConfig(model="hyperprior", n=N, m=M)
    model, opt = train.init_state(cfg, 0, "cpu")
    path = str(tmp_path / "ckpt_2.msgpack")
    train_ckpt.save(path, 2, model.state_dict(), opt)
    return path, model, opt


@pytest.mark.parametrize("fault", ["reshaped", "missing", "extra",
                                   "retyped"])
def test_restore_refuses_a_leaf_that_does_not_fit(fault, tmp_path):
    path, model, opt = _small_file(tmp_path)
    if fault == "reshaped":     # a template of another width
        model, opt = train.init_state(train.TrainConfig(
            model="hyperprior", n=N, m=M + 8), 0, "cpu")
    else:
        tree = msgpack_io.load(path)
        conv = tree["params"]["params"]["g_a"]["Conv_0"]
        if fault == "missing":
            del conv["bias"]
        elif fault == "extra":
            tree["opt_state"]["1"]["0"]["mu"]["params"]["g_a"]["extra"] = \
                np.zeros(3, np.float32)
        else:
            conv["bias"] = conv["bias"].astype(np.float64)
        msgpack_io.dump(path, tree)
    with pytest.raises(ValueError):
        train_ckpt.restore(path, model.state_dict(), opt)


def test_params_checkpoint_round_trip(tmp_path):
    model = train.build_model(train.TrainConfig(n=N, m=M), "cpu")
    path = str(tmp_path / "m.params.msgpack")
    train_ckpt.save_params(path, model.state_dict())
    got = train_ckpt.restore_params(path, model.state_dict())
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())
    j_model = j_train.build_model(j_train.TrainConfig(n=N, m=M))
    template = jax.jit(j_model.init)(jax.random.key(0),
                                     np.zeros((1, 64, 64, 3), np.float32))
    _assert_same(jax.tree_util.tree_map(np.asarray, unfreeze(
        j_ckpt.restore_params(path, template))),
        weights_io.hyper_params_to_jax(model.state_dict()))


def test_latest_in_numeric_order_and_atomic_save(tmp_path, monkeypatch):
    assert train_ckpt.latest(str(tmp_path / "none")) is None
    for step in (9, 10, 2):
        (tmp_path / f"ckpt_{step}.msgpack").write_bytes(b"")
    (tmp_path / "notes.txt").write_bytes(b"")
    want = str(tmp_path / "ckpt_10.msgpack")
    assert train_ckpt.latest(str(tmp_path)) == want
    assert j_ckpt.latest(str(tmp_path)) == want
    (tmp_path / "ckpt_best.msgpack").write_bytes(b"")   # not a step: skipped
    assert train_ckpt.latest(str(tmp_path)) == want
    # a save that fails leaves the target as it was and no temporary file
    path, model, opt = _small_file(tmp_path / "s")
    before = open(path, "rb").read()

    def fail(*a):
        raise OSError("disk full")
    monkeypatch.setattr(os, "replace", fail)
    with pytest.raises(OSError):
        train_ckpt.save(path, 3, model.state_dict(), opt)
    assert open(path, "rb").read() == before
    assert sorted(os.listdir(tmp_path / "s")) == ["ckpt_2.msgpack"]


# ---------------------------------------------------------------------------
# Serving a training checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    for i, img in enumerate(data.synthetic_images(2, 64, 64, seed=5)):
        Image.fromarray(img).save(d / f"im{i}.png")
    return d


@pytest.mark.parametrize("kind", ["hyperprior", "meanscale"])
def test_eval_codec_on_a_training_checkpoint_matches_jax(kind, folder,
                                                         tmp_path, capsys):
    """A training checkpoint (the released parameters and a fresh Adam
    state, as the port's train_loop writes it): both packages'
    ``eval_codec --ckpt`` give the same bpp, PSNR within 0.01 dB (the
    float transforms of two frameworks, as tests/test_torch_eval.py)."""
    model, opt = train.init_state(train.TrainConfig(model=kind), 0, "cpu")
    state = weights_io.hyper_params_from_jax(
        weights_io.load_hyper_checkpoint(RELEASED[kind]))
    path = str(tmp_path / "ckpt_5.msgpack")
    train_ckpt.save(path, 5, state, opt)
    argv = ["--data", str(folder), "--codec", kind, "--ckpt", path]
    want = j_eval.main(argv)
    got = eval_codec.main(argv + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("{") and '"n_images": 2' in line
    assert got["bpp"] == want["bpp"]
    assert abs(got["psnr"] - want["psnr"]) <= 0.01


def test_z_tables_of_a_training_checkpoint_match_jax(ckpt_10000):
    """The factorized z tables built from ``ckpt_10000``'s parameters are
    integer-equal to the JAX package's (ROADMAP queue 3: re-check each
    newly loaded checkpoint)."""
    model, opt = train.init_state(train.TrainConfig(), 0, "cpu")
    _, params, _ = train_ckpt.restore(TRAIN_CKPT, model.state_dict(), opt)
    serving = hyper_codec.HyperCodec.model_cls(device="cpu")
    serving.load_state_dict(params)
    got = hyper_codec.build_factorized_cdfs(serving)
    j_model = j_train.build_model(j_train.TrainConfig())
    want = j_hc.build_factorized_cdfs(j_model, ckpt_10000[1]["params"])
    np.testing.assert_array_equal(got, np.asarray(want))
