"""The port's rate-distortion training pieces (``train.py``, the training
forward of ``models/hyperprior.py``, ``codec/entropy.py``'s quantizers and
rates, ``ops/gdn.py:lower_bound``, ``utils/data.py``'s bank and crops)
against the JAX package's, at n = 16, m = 24, crop 64, B = 2, with JAX's
initialisation carried across and the noise drawn with ``jax.random``.

Tolerances (float32, two frameworks summing convolutions in other orders):
forward quantities (loss, bpp, mse, bits_y, bits_z) within 1e-5 relative;
each gradient leaf's max abs difference within 1e-3 of that leaf's max abs
JAX gradient; one clip+Adam step's change of the parameters within
1e-2 * lr wherever |g_jax| >= 1e-3 * (leaf max), and within 2 * lr
everywhere (Adam's first step is lr * g / (|g| + eps): where g is near 0
its sign is a rounding's)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from simple_image_compression_network_tpu import train as j_train
from simple_image_compression_network_tpu.codec import entropy as j_ent
from simple_image_compression_network_tpu.ops import gdn as j_gdn
from simple_image_compression_network_tpu.utils import data as j_data
from simple_image_compression_network_tpu_torch import train
from simple_image_compression_network_tpu_torch.codec import entropy
from simple_image_compression_network_tpu_torch.models import hyperprior
from simple_image_compression_network_tpu_torch.ops import gdn
from simple_image_compression_network_tpu_torch.utils import data, weights_io

torch.set_num_threads(1)

N, M, CROP, B = 16, 24, 64, 2
MODELS = ("hyperprior", "meanscale", "factorized")
FWD_RTOL = 1e-5
GRAD_TOL = 1e-3
STEP_TOL, STEP_MAX = 1e-2, 2.0      # times lr


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def _jax_noise(kind: str, key, x_shape):
    """The noise the JAX models draw from ``key`` (``quantize_noise``),
    NCHW for the port."""
    b, h, w, _ = x_shape
    y_shape, z_shape = (b, h // 16, w // 16, M), (b, h // 64, w // 64, N)

    def u(k, s):
        return _nchw(jax.random.uniform(k, s, jnp.float32, -0.5, 0.5))
    if kind == "factorized":
        return {"y": u(key, y_shape)}
    ky, kz = jax.random.split(key)
    return {"y": u(ky, y_shape), "z": u(kz, z_shape)}


@pytest.fixture(scope="module", params=MODELS)
def case(request):
    """One model: JAX's init, inputs, noise and every reference quantity
    (one jitted call), and the port's model carrying JAX's parameters."""
    kind = request.param
    cfg_j = j_train.TrainConfig(model=kind, n=N, m=M, crop=CROP, batch=B)
    model_j, params_j, opt_j = j_train.init_state(
        cfg_j, jax.random.key(7), input_shape=(B, CROP, CROP, 3))
    x = np.random.default_rng(11).random((B, CROP, CROP, 3), np.float32)
    key = jax.random.key(5)

    @jax.jit
    def reference(params, opt, x, key):
        def loss(p, k):
            return j_train.rd_loss(model_j, p, x, k, cfg_j.rd_lambda)
        (_, m_noise), g_noise = jax.value_and_grad(loss, has_aux=True)(
            params, key)
        (_, m_ste), g_ste = jax.value_and_grad(
            lambda p: loss(p, None), has_aux=True)(params)
        upd, _ = j_train.build_optimizer(cfg_j).update(g_noise, opt, params)
        return (model_j.apply(params, x, key=key), model_j.apply(params, x),
                m_noise, m_ste, g_noise, g_ste,
                optax.apply_updates(params, upd))

    (out_noise, out_ste, m_noise, m_ste, g_noise, g_ste,
     new_params) = jax.tree_util.tree_map(
        np.asarray, reference(params_j, opt_j, jnp.asarray(x), key))
    variables = _np_tree(params_j)
    cfg = train.TrainConfig(model=kind, n=N, m=M, crop=CROP, batch=B)

    def port_model():
        model = train.build_model(cfg, "cpu")
        model.load_state_dict(weights_io.hyper_params_from_jax(variables))
        return model

    return dict(kind=kind, cfg=cfg, port_model=port_model, x=x,
                noise=_jax_noise(kind, key, x.shape), variables=variables,
                out={"noise": out_noise, "ste": out_ste},
                metrics={"noise": m_noise, "ste": m_ste},
                grads={"noise": g_noise, "ste": g_ste}, new=new_params)


def _port_grads(model, loss) -> dict:
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return dict(zip(names, grads))


def _close(got, want, what):
    got = float(got.detach()) if torch.is_tensor(got) else float(got)
    want = float(want)
    assert abs(got - want) <= FWD_RTOL * abs(want), (what, got, want)


# ---------------------------------------------------------------------------
# lower_bound, GDN, quantizers, rates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x,sign,want", [(2.0, 1.0, 1.0), (0.5, 1.0, 0.0),
                                         (0.5, -1.0, -1.0)],
                         ids=["above-passes", "below-down-blocked",
                              "below-up-passes"])
def test_lower_bound_gradient_matches_jax(x, sign, want):
    """JAX's three cases (tests/test_float_models.py): above the bound the
    gradient passes; below it, only a gradient that pushes x up."""
    jg = float(jax.grad(lambda v: sign * j_gdn.lower_bound(v, 1.0))(x))
    t = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(sign * gdn.lower_bound(t, 1.0), [t])
    assert jg == want and float(g) == want
    assert float(gdn.lower_bound(torch.tensor(x), 1.0)) == max(x, 1.0)


@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_gdn_offdiagonal_gamma_gradients_match_jax(inverse):
    """At init gamma's off-diagonal raw values are 0, below the bound: a
    clamp would give them no gradient, and the GDN would stay diagonal."""
    c = 8
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 5, c)).astype(np.float32)
    w = rng.normal(size=(2, 5, 5, c)).astype(np.float32)
    mod_j = j_gdn.GDN(inverse=inverse)
    params = mod_j.init(jax.random.key(0), jnp.asarray(x))
    gj = jax.grad(lambda p: jnp.sum(mod_j.apply(p, jnp.asarray(x)) * w))(
        params)["params"]["gamma"]
    mod = gdn.GDN(c, inverse=inverse)
    out = mod(_nchw(x))
    (g,) = torch.autograd.grad(torch.sum(out * _nchw(w)), [mod.gamma])
    gj = np.asarray(gj)
    off = ~np.eye(c, dtype=bool)
    assert (np.abs(g.numpy()[off]) > 0).sum() > c      # many move
    np.testing.assert_array_equal(g.numpy()[off] != 0, gj[off] != 0)
    assert np.abs(g.numpy() - gj).max() <= GRAD_TOL * np.abs(gj).max()


def test_quantize_ste_matches_jax():
    x = np.array([0.4, 1.6, -2.3, 2.5, -0.5], np.float32)
    t = torch.tensor(x, requires_grad=True)
    q = entropy.quantize_ste(t)
    np.testing.assert_array_equal(q.detach().numpy(),
                                  np.asarray(j_ent.quantize_ste(x)))
    (g,) = torch.autograd.grad(torch.sum(q * 3.0), [t])
    jg = jax.grad(lambda v: jnp.sum(j_ent.quantize_ste(v) * 3.0))(x)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("with_mean", [False, True], ids=["scale", "mean"])
def test_gaussian_conditional_matches_jax(with_mean):
    """Likelihoods, bits and their gradients in y, scale (some below
    SCALE_MIN, where only an upward push passes) and mean."""
    rng = np.random.default_rng(9)
    y = np.round(rng.normal(scale=3, size=(64,))).astype(np.float32)
    s = rng.uniform(0.02, 6.0, size=(64,)).astype(np.float32)
    mu = rng.normal(size=(64,)).astype(np.float32) if with_mean else None
    args = (y, s) + ((mu,) if with_mean else ())
    want_p = np.asarray(j_ent.GaussianConditional.likelihood(*args))
    jgrads = jax.grad(lambda *a: j_ent.GaussianConditional.bits(*a),
                      argnums=tuple(range(len(args))))(*args)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got_p = entropy.GaussianConditional.likelihood(*ts)
    # a difference of two CDFs near 1 is good to an ulp or two of 1.0
    np.testing.assert_allclose(got_p.detach().numpy(), want_p, rtol=1e-5,
                               atol=2.0 ** -22)
    bits = entropy.GaussianConditional.bits(*ts)
    # tail probabilities are differences of CDFs near 1, each good to
    # ~2^-22 in either framework's erf: bits to that error over p, summed
    want_bits = float(j_ent.GaussianConditional.bits(*args))
    bound = float(np.sum(2.0 ** -22 / want_p)) / np.log(2.0)
    assert abs(float(bits.detach()) - want_bits) <= (
        bound + FWD_RTOL * abs(want_bits))
    # d bits / dp = -1 / (p ln 2) carries p's error: the gradients are
    # compared where that error is below GRAD_TOL (p > 2^-22 / GRAD_TOL),
    # which is most elements
    sound = want_p > 2.0 ** -22 / GRAD_TOL
    assert sound.mean() > 0.8
    for g, jg in zip(torch.autograd.grad(bits, ts), jgrads):
        jg = np.asarray(jg)[sound]
        assert np.abs(g.numpy()[sound] - jg).max() <= (
            GRAD_TOL * np.abs(jg).max())


def test_factorized_entropy_rate_matches_jax():
    """The bottleneck's rate and its parameters' gradients, JAX's init
    (b uniform) carried across."""
    c = 6
    y = np.round(np.random.default_rng(2).normal(scale=3, size=(40, c))
                 ).astype(np.float32)
    fe = j_ent.FactorizedEntropy(channels=c)
    params = fe.init(jax.random.key(1), jnp.asarray(y))
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: fe.apply(p, jnp.asarray(y))))(params)
    mod = entropy.FactorizedEntropy(c)
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params["params"].items()})
    rate = mod(torch.from_numpy(y))
    _close(rate, want, "rate")
    for name, g in zip([n for n, _ in mod.named_parameters()],
                       torch.autograd.grad(rate, list(mod.parameters()))):
        ref = np.asarray(jg["params"][name])
        assert np.abs(g.numpy() - ref).max() <= GRAD_TOL * np.abs(ref).max()


# ---------------------------------------------------------------------------
# The models' training forward, rd_loss, gradients, one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["noise", "ste"])
def test_training_forward_matches_jax(case, mode):
    model = case["port_model"]()
    noise = case["noise"] if mode == "noise" else None
    out = model(torch.from_numpy(case["x"]), noise=noise)
    want = case["out"][mode]
    assert set(out) == set(want)
    for k in ("bits", "bpp") + (("bits_y", "bits_z")
                                if case["kind"] != "factorized" else ()):
        _close(out[k], want[k], k)
    for k in set(out) - {"bits", "bpp", "bits_y", "bits_z"}:
        assert out[k].shape == want[k].shape, k
        np.testing.assert_allclose(out[k].detach().numpy(), want[k],
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    # B X Y pixels of the NHWC batch, not B 3 X of an NCHW one
    assert float(out["bpp"].detach()) == pytest.approx(
        float(out["bits"].detach()) / (B * CROP * CROP), rel=1e-6)


def test_training_forward_draws_its_noise_from_a_generator(case):
    """Given a generator, the forward adds ``noise_like``'s draw from it
    (y then z), as given those tensors."""
    model = case["port_model"]()
    x = torch.from_numpy(case["x"])
    got = model(x, generator=torch.Generator().manual_seed(3))
    noise = model.noise_like(x.shape, torch.Generator().manual_seed(3))
    assert list(noise) == list(model.latents)
    assert {k: tuple(v.shape) for k, v in noise.items()} == {
        k: tuple(v.shape) for k, v in case["noise"].items()}
    want = model(x, noise=noise)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", ["noise", "ste"])
def test_rd_loss_and_gradients_match_jax(case, mode):
    model = case["port_model"]()
    noise = case["noise"] if mode == "noise" else None
    loss, metrics = train.rd_loss(model, torch.from_numpy(case["x"]), noise,
                                  case["cfg"].rd_lambda)
    for k in ("loss", "bpp", "mse"):
        _close(metrics[k], case["metrics"][mode][k], k)
    assert float(metrics["psnr"].detach()) == pytest.approx(
        float(case["metrics"][mode]["psnr"]), abs=1e-4)
    got = _port_grads(model, loss)
    want = weights_io.hyper_params_from_jax(case["grads"][mode])
    assert set(got) == set(want)
    for k, g in got.items():
        ref = want[k].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (k, err)
    # the channel mix trains: off-diagonal gamma gradients move
    gamma = got["g_a.GDN_0.gamma"].numpy()
    assert np.count_nonzero(gamma[~np.eye(N, dtype=bool)]) > N


def test_train_step_matches_optax(case):
    """One ``make_train_step`` (noise mode) against JAX's value_and_grad
    and optax's clip + Adam on the same parameters, batch and noise."""
    model = case["port_model"]()
    cfg = case["cfg"]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = train.build_optimizer(cfg).init(dict(model.named_parameters()))
    metrics = train.make_train_step(cfg, model)(
        opt, torch.from_numpy(case["x"]), case["noise"])
    _close(metrics["loss"], case["metrics"]["noise"]["loss"], "loss")
    assert opt.count == 1
    want = weights_io.hyper_params_from_jax(case["new"])
    start = weights_io.hyper_params_from_jax(case["variables"])
    grads = weights_io.hyper_params_from_jax(case["grads"]["noise"])
    lr = cfg.lr
    for k, v in model.state_dict().items():
        d_port = (v - before[k]).numpy()
        d_jax = (want[k] - start[k]).numpy()
        g = np.abs(grads[k].numpy())
        big = g >= 1e-3 * g.max()
        diff = np.abs(d_port - d_jax)
        assert diff.max() <= STEP_MAX * lr, k
        assert (diff[big] <= STEP_TOL * lr).all(), (k, diff[big].max())


@pytest.mark.parametrize("norm", [0.5, 3.0], ids=["below", "above"])
def test_clip_matches_optax(norm):
    """optax keeps g below the bound and divides by the norm above it
    (``clip_grad_norm_`` would scale by 1 / (norm + 1e-6) always)."""
    rng = np.random.default_rng(4)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,))]
    scale = norm / np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                               for g in gs))
    gs = [(g * scale).astype(np.float32) for g in gs]
    want, _ = optax.clip_by_global_norm(1.0).update(gs, optax.EmptyState())
    got = train.ClipAdam.clip([torch.from_numpy(g) for g in gs])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if norm < 1:
        for a, b in zip(got, gs):
            np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["g_a.Conv_1", "g_s.ConvTranspose_1"])
def test_init_is_flax_lecun_normal(layer):
    """A 128-channel 5x5 layer: std within 5% of lecun's sqrt(1/fan_in)
    (fan_in = 128 * 5 * 5 for both flax Conv and ConvTranspose), cut at
    2 sigma of the untruncated normal, zero bias; as JAX's init."""
    model = hyperprior.FactorizedPrior(n=128, m=192, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    mod = model.get_submodule(layer)
    w = mod.weight.detach().numpy()
    std = (1.0 / (128 * 25)) ** 0.5
    cut = 2 * std / 0.87962566103423978
    assert abs(w.std() / std - 1) < 0.05
    assert np.abs(w).max() <= cut and np.abs(w).max() > 0.98 * cut
    assert not mod.bias.detach().numpy().any()
    variables = j_train.init_state(
        j_train.TrainConfig(model="factorized"), jax.random.key(0),
        input_shape=(1, 64, 64, 3))[1]
    sub, name = layer.split(".")
    k = np.asarray(variables["params"][sub][name]["kernel"])
    assert abs(k.std() / std - 1) < 0.05 and np.abs(k).max() <= cut


def test_init_state_is_seeded_with_jax_structure():
    """init_state: the same parameters for the same seed, other ones for
    another; names and shapes of JAX's init; the bottleneck's H as JAX's,
    b in [-1/2, 1/2), a and the biases zero, GDN as JAX's."""
    cfg = train.TrainConfig(model="hyperprior", n=N, m=M)
    a, opt = train.init_state(cfg, 3, "cpu")
    b, _ = train.init_state(cfg, 3, "cpu")
    c, _ = train.init_state(cfg, 4, "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["g_a.Conv_0.weight"], sc["g_a.Conv_0.weight"])
    assert opt.count == 0 and all(not v.any() for v in opt.mu.values())
    jv = _np_tree(j_train.init_state(
        j_train.TrainConfig(model="hyperprior", n=N, m=M),
        jax.random.key(0), input_shape=(1, 64, 64, 3))[1])
    want = weights_io.hyper_params_from_jax(jv)
    assert {k: tuple(v.shape) for k, v in sa.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for k, v in sa.items():
        if k.split(".")[-1] in ("H0", "H1", "H2", "H3", "beta", "gamma",
                                "a0", "a1", "a2", "bias"):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-6, err_msg=k)
    bs = torch.cat([sa[f"bottleneck.b{i}"].reshape(-1) for i in range(4)])
    assert bs.min() >= -0.5 and bs.max() < 0.5 and bs.std() > 0.2


# ---------------------------------------------------------------------------
# The training data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sources", ["bundled", "absent"])
def test_training_bank_matches_jax(sources, monkeypatch):
    """The same bank for the same seed: with the bundled photos and screens
    (where this machine has them) and with both sources absent, where the
    port does not import PIL at all."""
    if sources == "absent":
        for mod in (data, j_data):
            monkeypatch.setattr(mod, "bundled_photos", lambda: [])
            monkeypatch.setattr(mod, "bundled_screens", lambda: [])
    want = j_data.training_bank(8, 96, 96, seed=3)
    if sources == "absent":
        monkeypatch.setitem(sys.modules, "PIL", None)    # import raises
    got = data.training_bank(8, 96, 96, seed=3)
    assert got.dtype == np.uint8 and got.shape == (8, 96, 96, 3)
    np.testing.assert_array_equal(got, want)


def test_bundled_sources_match_jax():
    photos, screens = data.bundled_photos(), data.bundled_screens()
    for got, want in ((photos, j_data.bundled_photos()),
                      (screens, j_data.bundled_screens())):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_random_crops_and_crop_batches_match_jax():
    images = data.synthetic_images(3, 80, 72, seed=1)
    got = data.random_crops(images, 32, 4, np.random.default_rng(8))
    want = j_data.random_crops(images, 32, 4, np.random.default_rng(8))
    assert got.dtype == np.float32 and got.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(data.crop_batches(images, 16, 2, 3, seed=5),
                    j_data.crop_batches(images, 16, 2, 3, seed=5)):
        np.testing.assert_array_equal(a, b)


def test_device_random_crops_are_slices_of_the_bank():
    bank = torch.from_numpy(data.synthetic_images(5, 40, 48, seed=2))
    gen = train.step_generator(torch.Generator(), 0, 7)
    crops = train.device_random_crops(bank, 16, 6, gen)
    assert crops.dtype == torch.float32 and crops.shape == (6, 16, 16, 3)
    g2 = train.step_generator(torch.Generator(), 0, 7)
    idx = torch.randint(0, 5, (6,), generator=g2)
    ox = torch.randint(0, 40 - 16 + 1, (6,), generator=g2)
    oy = torch.randint(0, 48 - 16 + 1, (6,), generator=g2)
    for b in range(6):
        i, sx, sy = int(idx[b]), int(ox[b]), int(oy[b])
        want = bank[i, sx:sx + 16, sy:sy + 16].to(torch.float32) / 255.0
        assert torch.equal(crops[b], want)
