"""The port's wrap-STE integer training (``intnet.py``, ``train_intnet.py``)
against the JAX package's, at ``reference_net_for_input(64, 64)`` (the
geometry of tests/test_intnet_haar.py) and B = 1, with JAX's
initialisation carried across (``intnet_params_from_jax``).

Tolerances:
* ``forward`` in "wrap" and "clip": x_hat and z bitwise; the penalty
  bitwise on the Haar shadows' own wire, and within 1e-6 relative where
  a layer's mean adds some 10^5 terms in multiples of 1/128 past float32's
  exact range (2^17), in XLA's order or in torch's (JAX's random init,
  and the Haar shadows on the >> 1 wire).
* "float" (no integer path): each layer on JAX's input within 2e-6 of the
  layer's largest |acc| (float32 sums of 25 * C products in two orders;
  clipped chains of such layers amplify that, so the chain is not held).
* ``loss_fn``: the metrics within 1e-5 relative; each gradient leaf's max
  abs difference within 1e-3 of the leaf's max abs JAX gradient.
* one optimizer step, each form, on JAX's gradients: the new parameter
  within two of its ulps plus 1e-5 * lr where |g| >= 1e-3 * (leaf max),
  plus 2 * lr everywhere (Adam's first step is lr * g / (|g| + eps), its
  sign a rounding's where g is near 0); ``ent_only`` leaves every
  other leaf bitwise unchanged, ``grad_mask`` every masked element.
* export, masks, shadow files: exact."""

import os

import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu_torch import (
    intnet, intnet_haar, train_intnet)
from simple_image_compression_network_tpu_torch.config import (
    reference_net_for_input)
from simple_image_compression_network_tpu_torch.models import codec_int
from simple_image_compression_network_tpu_torch.ops import cuda_conv
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

SIDE = 64
FWD_RTOL, PEN_RTOL, FLOAT_LAYER_TOL = 1e-5, 1e-6, 2e-6
GRAD_TOL = 1e-3
STEP_TOL, STEP_MAX = 1e-5, 2.0        # times lr
EPS32 = float(np.finfo(np.float32).eps)
LOSS_CASES = [("wrap", "half"), ("wrap", "ycocg"), ("clip", "half")]
OPT_FORMS = ("plain", "ent_only", "grad_mask")
NET = reference_net_for_input(SIDE, SIDE)


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """JAX's init, the Haar shadows, one batch, and every reference
    quantity, each from one jitted call."""
    import jax
    import jax.numpy as jnp
    import optax
    from simple_image_compression_network_tpu import intnet as j_intnet
    from simple_image_compression_network_tpu import intnet_haar as j_haar
    from simple_image_compression_network_tpu.config import (
        reference_net_for_input as j_net)
    net = j_net(SIDE, SIDE)
    cfg = j_intnet.IntNetTrainConfig(crop=SIDE, batch=1)
    params = j_intnet.init_params(cfg, jax.random.key(3), net)
    hp = j_haar.haar_params(net)
    haar = dict(params)
    haar.update({k: jnp.asarray(v, jnp.float32) for k, v in hp.items()
                 if not k.startswith("disp")})
    x = np.random.default_rng(0).integers(0, 256, (1, SIDE, SIDE, 3)
                                          ).astype(np.float32)
    xh = jnp.floor(jnp.asarray(x) / 2.0)

    fwd = {}
    for mode in ("wrap", "clip"):
        f = jax.jit(lambda p, m=mode: j_intnet.forward(p, xh, net, mode=m))
        fwd[mode, "init"] = _np(f(params))
        fwd[mode, "haar"] = _np(f(haar))

    @jax.jit
    def float_layers(p):
        h, outs = xh, []
        for i, layer in enumerate(net.layers):
            outs.append((h, j_intnet._layer(h, p[f"w{i}"], p[f"b{i}"],
                                            layer.transposed, "float")[0]))
            h = outs[-1][1]
        return outs
    wire_u8 = np.random.default_rng(1).integers(
        0, 256, (1, SIDE, SIDE, 3), dtype=np.uint8)
    haar_wrap = _np(jax.jit(lambda p: j_intnet.forward(
        p, jnp.asarray((wire_u8 >> 2).astype(np.float32)), net,
        mode="wrap"))(haar))

    losses = {}
    for mode, wire in LOSS_CASES:
        c = j_intnet.IntNetTrainConfig(crop=SIDE, batch=1, mode=mode,
                                       wire=wire)
        f = jax.jit(jax.value_and_grad(
            lambda p, c=c: j_intnet.loss_fn(p, jnp.asarray(x), c, net),
            has_aux=True))
        (_, metrics), grads = f(params)
        losses[mode, wire] = (_np(metrics), _np(grads))
    grads = losses["wrap", "half"][1]
    mask = j_intnet.grad_mask_from_structure(hp, params)
    steps = {}
    for form in OPT_FORMS:
        tx = j_intnet.build_optimizer(
            cfg, ent_only=form == "ent_only",
            grad_mask=mask if form == "grad_mask" else None)
        upd, _ = jax.jit(tx.update)(grads, tx.init(params), params)
        steps[form] = _np(optax.apply_updates(params, upd))
    return dict(params=_np(params), haar=_np(haar), hp=hp, x=x, fwd=fwd,
                float_layers=_np(float_layers(params)), wire_u8=wire_u8,
                haar_wrap=haar_wrap, losses=losses, steps=steps,
                mask=_np(mask),
                export=j_intnet.export_int_params(params, net))


def _port(tree) -> dict:
    return intnet.intnet_params_from_jax(tree)


@pytest.mark.parametrize("start", ["init", "haar"])
@pytest.mark.parametrize("mode", ["wrap", "clip"])
def test_forward_integer_modes_equal_jax_bitwise(ref, mode, start):
    params = _port(ref["params" if start == "init" else "haar"])
    cuda_conv.conv3x3_s1_int8.plain_runs = 0
    x_hat, z, pen = intnet.forward(
        params, torch.floor(torch.from_numpy(ref["x"]) / 2.0), NET,
        mode=mode)
    # the wrap-mode value runs kernel A's forms, 8 layers; clip none
    assert cuda_conv.conv3x3_s1_int8.plain_runs == (8 if mode == "wrap"
                                                    else 0)
    jx, jz, jpen = ref["fwd"][mode, start]
    assert x_hat.dtype == torch.float32 and x_hat.shape == jx.shape
    np.testing.assert_array_equal(x_hat.numpy(), jx)
    np.testing.assert_array_equal(z.numpy(), jz)
    assert abs(float(pen) - float(jpen)) <= PEN_RTOL * abs(float(jpen))


def test_float_mode_layers_within_tolerance(ref):
    params = _port(ref["params"])
    for i, (layer, (h, want)) in enumerate(zip(NET.layers,
                                               ref["float_layers"])):
        y, _ = intnet._layer(torch.from_numpy(np.array(h)), params[f"w{i}"],
                             params[f"b{i}"], layer.transposed, "float")
        wq = torch.clamp(params[f"w{i}"], -8, 7)
        acc = intnet._acc_f(torch.from_numpy(np.array(h)), wq,
                            layer.transposed).abs().max()
        diff = float((y - torch.from_numpy(np.array(want))).abs().max())
        assert diff <= FLOAT_LAYER_TOL * float(acc), (i, diff, float(acc))


def test_haar_shadows_forward_equals_eight_layers_net_and_jax(ref):
    """tests/test_intnet_haar.py:59-72 on the port: the Haar shadows'
    wrap forward is the deployed integer net on the >> 2 wire."""
    x = ref["wire_u8"]
    y, z, pen = intnet.forward(
        _port(ref["haar"]), torch.from_numpy((x >> 2).astype(np.float32)),
        NET, mode="wrap")
    deployed = codec_int.eight_layers_net(
        weights_io.params_from_jax({k: v for k, v in ref["hp"].items()
                                    if not k.startswith("disp")}),
        torch.from_numpy(intnet_haar.to_wire(x)), NET)
    np.testing.assert_array_equal(y.numpy().astype(np.int8),
                                  deployed.numpy())
    jy, jz, jpen = ref["haar_wrap"]
    np.testing.assert_array_equal(y.numpy(), jy)
    np.testing.assert_array_equal(z.numpy(), jz)
    assert float(pen) == float(jpen)


@pytest.mark.parametrize("mode,wire", LOSS_CASES)
def test_loss_and_gradients_match_jax(ref, mode, wire):
    cfg = intnet.IntNetTrainConfig(crop=SIDE, batch=1, mode=mode, wire=wire)
    params = _port(ref["params"])
    for v in params.values():
        v.requires_grad_(True)
    loss, metrics = intnet.loss_fn(params, torch.from_numpy(ref["x"]), cfg,
                                   NET)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    want_m, want_g = ref["losses"][mode, wire]
    assert set(metrics) == set(want_m)
    for k, v in want_m.items():
        got = float(metrics[k].detach())
        assert abs(got - float(v)) <= FWD_RTOL * abs(float(v)), (k, got, v)
    want_g = _port(want_g)
    for (k, g) in zip(params, grads):
        scale = float(want_g[k].abs().max())
        diff = float((g - want_g[k]).abs().max())
        assert diff <= GRAD_TOL * scale or diff == 0.0, (k, diff, scale)


@pytest.mark.parametrize("form", OPT_FORMS)
def test_one_step_of_each_optimizer_form_matches_optax(ref, form):
    """Port and optax take the same (JAX's) gradients, so the step alone
    is compared."""
    cfg = intnet.IntNetTrainConfig(crop=SIDE, batch=1)
    params = _port(ref["params"])
    before = {k: v.clone() for k, v in params.items()}
    grads = _port(ref["losses"]["wrap", "half"][1])
    mask = _port(ref["mask"]) if form == "grad_mask" else None
    tx = intnet.build_optimizer(cfg, ent_only=form == "ent_only",
                                grad_mask=mask)
    names = tx.names(params)
    tx.update(params, [grads[k] for k in names], tx.init(params))
    want = _port(ref["steps"][form])
    for k, v in params.items():
        if form == "ent_only" and not k.startswith(intnet.ENT):
            assert torch.equal(v, before[k]) and torch.equal(v, want[k]), k
            continue
        # in lr, less two ulps of the parameter (the add's rounding)
        diff = ((v - want[k]).abs() - 2 * EPS32 * want[k].abs()) / cfg.lr
        big = grads[k].abs() >= 1e-3 * grads[k].abs().max()
        assert float(diff.max()) <= STEP_MAX, k
        if big.any():
            assert float(diff[big].max()) <= STEP_TOL, (k, float(diff.max()))
        if mask is not None:
            frozen = mask[k] == 0
            assert torch.equal(v[frozen], before[k][frozen]), k


def test_grad_mask_and_export_equal_jax(ref):
    params = _port(ref["params"])
    mask = intnet.grad_mask_from_structure(ref["hp"], params)
    want = _port(ref["mask"])
    assert list(mask) == list(params)
    for k, v in want.items():
        assert torch.equal(mask[k], v), k
    got = intnet.export_int_params(params, NET)
    assert sorted(got) == sorted(ref["export"])
    for k, v in ref["export"].items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_params_tree_round_trips_and_init_has_jax_shapes(ref):
    tree = ref["params"]
    back = intnet.intnet_params_to_jax(_port(tree))
    assert list(back) == sorted(tree)
    assert list(back["ent"]["params"]) == sorted(tree["ent"]["params"])
    for k, v in tree.items():
        if k == "ent":
            for e, a in v["params"].items():
                np.testing.assert_array_equal(back["ent"]["params"][e], a)
        else:
            np.testing.assert_array_equal(back[k], v)
    cfg = intnet.IntNetTrainConfig(crop=SIDE, batch=1)
    mine = intnet.init_params(cfg, torch.Generator().manual_seed(0), NET,
                              "cpu")
    assert list(mine) == list(_port(tree))
    for k, v in _port(tree).items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
    assert torch.equal(mine["disp_a"], torch.full((3,), 2.0))
    for i, layer in enumerate(NET.layers):
        std = max(0.3, 24.0 / np.sqrt(layer.kernel ** 2 * layer.in_ch))
        assert abs(float(mine[f"w{i}"].std()) / std - 1) < 0.1, i
        assert not mine[f"b{i}"].any()


def test_block_draws_each_step_from_its_seed():
    """A block of 2 steps equals two blocks of 1: crops come from each
    step's own generator."""
    cfg = intnet.IntNetTrainConfig(crop=SIDE, batch=1, mode="clip")
    bank = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (3, 96, 96, 3), dtype=np.uint8))
    runs = []
    for blocks in ((0, 2), (0, 1, 1, 1)):
        params = intnet.init_params(cfg, torch.Generator().manual_seed(1),
                                    NET, "cpu")
        block = intnet.make_train_block(cfg, NET)
        opt = block.tx.init(params)
        for start, n in zip(blocks[::2], blocks[1::2]):
            m = block(params, opt, bank, 5, start, n)
        runs.append((params, m))
    for k, v in runs[0][0].items():
        assert torch.equal(v, runs[1][0][k]), k
    assert opt.count == 2


SMALL = ["--crop", str(SIDE), "--batch", "1", "--log-every", "1",
         "--device", "cpu"]


@pytest.fixture
def small_bank(monkeypatch):
    """train_intnet's training images, smaller and quicker to make than
    the 48 mixed 512 x 512 images of its bank."""
    from simple_image_compression_network_tpu_torch.utils import data
    monkeypatch.setattr(train_intnet, "_bank", lambda seed: (
        data.synthetic_images(4, 2 * SIDE, 2 * SIDE, seed=seed)))


def test_train_intnet_main_files_read_by_jax_and_resumed_from_jax(
        ref, tmp_path, capsys, small_bank):
    """2 steps a phase to a temporary --out-dir: JAX's restore_params reads
    the shadows, the npz is their export, the CDFs are the static table
    of the exported net.  Then a JAX-written shadow file resumed by the
    port (0 steps) is written back unchanged."""
    import jax
    from simple_image_compression_network_tpu import intnet as j_intnet
    from simple_image_compression_network_tpu.config import (
        reference_net_for_input as j_net)
    from simple_image_compression_network_tpu.utils import (
        train_ckpt as j_ckpt)
    out = str(tmp_path / "run")
    params = train_intnet.main(["--float-steps", "2", "--pretrain", "2",
                                "--steps", "2", "--out-dir", out] + SMALL)
    text = capsys.readouterr().out
    for tag in ("float", "clip", "wrap"):
        assert f"[{tag}] step      2  loss" in text
    assert sorted(os.listdir(out)) == ["intnet_cdfs.npz",
                                       "intnet_trained.msgpack",
                                       "intnet_trained.npz"]
    template = j_intnet.init_params(j_intnet.IntNetTrainConfig(),
                                    jax.random.key(0), j_net(SIDE, SIDE))
    restored = _np(j_ckpt.restore_params(
        os.path.join(out, "intnet_trained.msgpack"), template))
    for k, v in _port(restored).items():
        assert torch.equal(v, params[k]), k
    ints = dict(np.load(os.path.join(out, "intnet_trained.npz")))
    for k, v in intnet.export_int_params(params, NET).items():
        np.testing.assert_array_equal(ints[k], v, err_msg=k)
    cdfs = np.load(os.path.join(out, "intnet_cdfs.npz"))["cdfs"]
    assert cdfs.shape == (192, 130) and (cdfs[:, -1] == 1 << 16).all()

    jax_file = str(tmp_path / "jax_shadows.msgpack")
    j_ckpt.save_params(jax_file, ref["params"])
    again = str(tmp_path / "again")
    resumed = train_intnet.main(["--resume", jax_file, "--steps", "0",
                                 "--out-dir", again] + SMALL)
    assert f"resumed shadows from {jax_file}" in capsys.readouterr().out
    for k, v in _port(ref["params"]).items():
        assert torch.equal(resumed[k], v), k
    with open(jax_file, "rb") as a, open(
            os.path.join(again, "intnet_trained.msgpack"), "rb") as b:
        assert a.read() == b.read()


def test_train_intnet_haar_freeze_structure_keeps_the_construction(
        tmp_path, capsys, small_bank):
    out = str(tmp_path / "haar")
    params = train_intnet.main(["--init-haar", "haar422",
                                "--freeze-structure", "--ent-warmup", "1",
                                "--steps", "2", "--out-dir", out] + SMALL)
    text = capsys.readouterr().out
    assert "initialized shadows from wavelet profile haar422" in text
    assert "[ent-warmup] step      1" in text and "[wrap] step      2" in text
    hp = intnet_haar.haar_params(
        NET, det2_keep=(0, 1, 2, 3, 4, 6, 7))
    moved = 0
    for k, v in hp.items():
        if k.startswith("disp"):
            continue
        got = params[k].numpy()
        structural = v != 0
        np.testing.assert_array_equal(got[structural],
                                      v[structural].astype(np.float32))
        moved += int((got[~structural] != 0).sum())
    assert moved > 0        # the free pathways trained
    ints = dict(np.load(os.path.join(out, "intnet_trained.npz")))
    for k, v in hp.items():
        if not k.startswith("disp"):
            np.testing.assert_array_equal(ints[k][v != 0], v[v != 0])
