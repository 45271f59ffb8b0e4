"""The port's scale-hyperprior codec (the package
simple_image_compression_network_tpu_torch) against the JAX package: the msgpack reader, the float modules (float32,
atol = rtol = 1e-4: the two frameworks sum convolutions in other orders),
the integer tables, the context rANS coder (exact, against the lax.scan coder
and the Pallas kernels in interpret mode) and the device-format containers
(byte-identical for identical integers)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.core import unfreeze

from simple_image_compression_network_tpu.codec import device_rans as j_dev
from simple_image_compression_network_tpu.codec import entropy as j_ent
from simple_image_compression_network_tpu.codec import hyper_codec as j_hc
from simple_image_compression_network_tpu.codec import pallas_rans
from simple_image_compression_network_tpu.models import hyperprior as j_hp
from simple_image_compression_network_tpu.ops.gdn import GDN as JGDN
from simple_image_compression_network_tpu_torch.codec import (
    container, cuda_rans, device_rans, entropy, escape, hyper_codec)
from simple_image_compression_network_tpu_torch.models import hyperprior
from simple_image_compression_network_tpu_torch.ops.gdn import GDN
from simple_image_compression_network_tpu_torch.utils import (
    msgpack_io, weights_io)

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "hp_scale_l0.01.params.msgpack")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def trained():
    """The trained checkpoint: (JAX model, flax variables, port model)."""
    variables = weights_io.load_hyper_checkpoint(CKPT)
    port = hyperprior.ScaleHyperprior.from_checkpoint(CKPT, device="cpu")
    return j_hp.ScaleHyperprior(), variables, port


@pytest.fixture(scope="module")
def seeded():
    """Seeded n=8, m=12 parameters: (JAX model, flax variables, port)."""
    model = j_hp.ScaleHyperprior(n=8, m=12)
    variables = jax.tree_util.tree_map(np.asarray, unfreeze(model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))))
    port = hyperprior.ScaleHyperprior(n=8, m=12, device="cpu")
    port.load_state_dict(weights_io.hyper_params_from_jax(variables))
    return model, variables, port


@pytest.fixture(scope="module")
def codecs(trained):
    """(JAX HyperCodec, port HyperCodec) on the trained checkpoint."""
    model, variables, port = trained
    return j_hc.HyperCodec(model, variables), hyper_codec.HyperCodec(port)


# ---------------------------------------------------------------------------
# msgpack reader and weights
# ---------------------------------------------------------------------------

def _assert_same_tree(a, b, path=""):
    assert isinstance(b, dict) == isinstance(a, dict), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert isinstance(b, np.ndarray), path
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_msgpack_reader_matches_flax():
    with open(CKPT, "rb") as f:
        data = f.read()
    _assert_same_tree(serialization.msgpack_restore(data),
                      msgpack_io.loads(data))


@pytest.mark.parametrize("data", [
    b"\xc0",                                  # nil
    b"\x81\xa1k\xcb" + bytes(8),              # float64 value
    b"\xc7\x01\x02\x00",                      # ext type 2 (complex)
    b"\x81\xa1k",                             # truncated map
    b"\x90\x90",                              # trailing bytes
])
def test_msgpack_reader_rejects_what_it_does_not_read(data):
    with pytest.raises(ValueError):
        msgpack_io.loads(data)


def test_hyper_state_dict_covers_the_port_model(trained):
    _, variables, port = trained
    state = weights_io.hyper_params_from_jax(variables)
    assert sorted(state) == sorted(port.state_dict())
    k = variables["params"]["g_s"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(
        state["g_s.ConvTranspose_0.weight"].numpy(),
        np.flip(k.transpose(2, 3, 0, 1), (2, 3)))


# ---------------------------------------------------------------------------
# Float modules
# ---------------------------------------------------------------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _module_case(which, setup, name):
    """-> (JAX output, port output) of one module on seeded inputs."""
    model, variables, port = setup
    n, m = port.n, port.m
    b = 2 if which == "seeded" else 1
    rng = np.random.default_rng(7)
    params = variables["params"]
    if name in ("gdn", "igdn"):
        sub, inverse = ("g_a", False) if name == "gdn" else ("g_s", True)
        x = rng.normal(size=(b, 16, 16, n)).astype(np.float32)
        ref = JGDN(inverse=inverse).apply(
            {"params": params[sub]["GDN_1"]}, jnp.asarray(x))
        mod = GDN(n, inverse=inverse)
        mod.load_state_dict({k: torch.from_numpy(np.array(v))
                             for k, v in params[sub]["GDN_1"].items()})
        with torch.no_grad():
            return np.asarray(ref), _nhwc(mod(_nchw(x)))
    if name == "bottleneck":
        x = np.round(rng.normal(scale=4.0, size=(b, 4, 4, n))).astype(
            np.float32)
        ref = model.apply(variables, jnp.asarray(x),
                          method=lambda mm, v: mm.bottleneck.likelihood(v))
        with torch.no_grad():
            return (np.asarray(ref),
                    port.bottleneck.likelihood(torch.from_numpy(x)).numpy())
    shapes = {"g_a": (64, 64, 3), "g_s": (4, 4, m), "h_a": (4, 4, m),
              "h_s": (1, 1, n)}
    x = rng.normal(size=(b,) + shapes[name]).astype(np.float32)
    if name == "g_a":
        x = rng.random(size=(b,) + shapes[name]).astype(np.float32)
    if name == "h_s":
        x = np.round(3 * x)
    ref = model.apply(variables, jnp.asarray(x),
                      method=lambda mm, v: getattr(mm, name)(v))
    with torch.no_grad():
        return np.asarray(ref), _nhwc(getattr(port, name)(_nchw(x)))


@pytest.mark.parametrize("name", ["gdn", "igdn", "g_a", "g_s", "h_a", "h_s",
                                  "bottleneck"])
@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_modules_match_jax(request, which, name):
    ref, got = _module_case(which, request.getfixturevalue(which), name)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_public_methods_are_nhwc_and_match_jax(trained):
    model, variables, port = trained
    x = np.random.default_rng(2).random((1, 64, 64, 3), np.float32)
    y, z = model.apply(variables, jnp.asarray(x),
                       method=model.analysis_arrays)
    ty, tz = port.analysis_arrays(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    sigma = model.apply(variables, z, method=model.scales_from_z)
    np.testing.assert_allclose(
        port.scales_from_z(torch.from_numpy(np.array(z))).numpy(),
        np.asarray(sigma), **TOL)
    y_hat = np.round(np.asarray(y))
    np.testing.assert_allclose(
        port.decode_arrays(torch.from_numpy(y_hat)).numpy(),
        np.asarray(model.apply(variables, jnp.asarray(y_hat),
                               method=model.decode_arrays)), **TOL)


# ---------------------------------------------------------------------------
# Integer tables
# ---------------------------------------------------------------------------

def test_factorized_tables_match_jax(codecs):
    """Integer for integer on the trained checkpoint.  (The pmf is float32
    in both packages; with other parameters a one-ulp difference between
    the frameworks' float32 ops can move one rounding of the table.)"""
    j_codec, t_codec = codecs
    assert t_codec.z_cdfs.dtype == np.int32
    np.testing.assert_array_equal(t_codec.z_cdfs, j_codec.z_cdfs)


@pytest.mark.parametrize("max_abs", [1, 63, 127, 255])
def test_gaussian_tables_match_jax(max_abs):
    table = entropy.default_scale_table()
    np.testing.assert_array_equal(table, j_ent.default_scale_table())
    np.testing.assert_array_equal(
        hyper_codec.build_gaussian_cdfs(table, max_abs),
        j_hc.build_gaussian_cdfs(table, max_abs))


def test_scale_ctx_matches_jax(codecs):
    j_codec, t_codec = codecs
    rng = np.random.default_rng(5)
    sigma = np.exp(rng.uniform(np.log(0.01), np.log(400), size=(3, 7, 11)))
    sigma = np.concatenate([sigma.ravel(), t_codec.scale_table,
                            np.nextafter(t_codec.scale_table, 0)])
    sigma = sigma.astype(np.float32)
    np.testing.assert_array_equal(
        t_codec._scale_ctx(torch.from_numpy(sigma)).numpy(),
        np.asarray(j_codec._scale_ctx(jnp.asarray(sigma))))
    np.testing.assert_array_equal(
        entropy.scale_to_index(sigma, t_codec.scale_table),
        j_ent.scale_to_index(sigma, j_codec.scale_table))


# ---------------------------------------------------------------------------
# Context rANS coder (plain versions of kernels D and E)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx_case():
    """The shapes of the JAX package's own ctx-kernel test: 16 rows of 40
    symbols, 4 streams x 12 steps x 32 lanes; escapes (the last symbol)
    forced at 9 positions."""
    rng = np.random.default_rng(11)
    n_rows, n_sym, s, t, n = 16, 40, 4, 12, 32
    cdfs = np.stack([j_ent.quantize_cdf(rng.dirichlet(np.ones(n_sym) * 0.4))
                     for _ in range(n_rows)]).astype(np.int32)
    ctx = rng.integers(0, n_rows, size=(s, t, n)).astype(np.int32)
    syms = rng.integers(0, n_sym - 1, size=(s, t, n)).astype(np.int32)
    syms.reshape(-1)[rng.choice(syms.size, 9, replace=False)] = n_sym - 1
    return cdfs, ctx, syms


def test_ctx_encode_matches_scan_and_pallas(ctx_case):
    cdfs, ctx, syms = ctx_case
    before = cuda_rans.encode_batch_compact_ctx.plain_runs
    words, counts = cuda_rans.encode_batch_compact(
        torch.from_numpy(syms), torch.from_numpy(cdfs),
        ctx=torch.from_numpy(ctx))
    assert cuda_rans.encode_batch_compact_ctx.plain_runs == before + 1
    words = words.numpy().view(np.uint16)
    s_words, s_counts = jax.vmap(lambda sy, c: j_dev.encode(
        sy, jnp.asarray(cdfs), c))(jnp.asarray(syms), jnp.asarray(ctx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(s_counts))
    np.testing.assert_array_equal(words, np.asarray(s_words))
    p_words, p_counts = pallas_rans.encode_batch_compact(
        jnp.asarray(syms), jnp.asarray(cdfs), jnp.asarray(ctx),
        cap_words=2048, interpret=True)
    p_words = np.asarray(p_words)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(p_counts))
    for j, c in enumerate(counts.numpy()):
        np.testing.assert_array_equal(words[j, :c], p_words[j, :c])


def test_ctx_decode_matches_scan_and_pallas(ctx_case):
    cdfs, ctx, syms = ctx_case
    t_steps, n = syms.shape[1:]
    words, counts = device_rans.encode(torch.from_numpy(syms),
                                       torch.from_numpy(cdfs),
                                       torch.from_numpy(ctx))
    cap = int(counts.max())
    w16 = torch.from_numpy(words[:, :cap].numpy().astype(np.uint16)
                           .view(np.int16))
    x0 = cuda_rans.split_init(w16, n)
    before = cuda_rans.decode_ctx.plain_runs
    got, cons, x_fin = cuda_rans.decode_ctx(
        w16, x0, torch.from_numpy(cdfs), torch.from_numpy(ctx), t_steps)
    assert cuda_rans.decode_ctx.plain_runs == before + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), syms)
    np.testing.assert_array_equal(cons.numpy(), counts.numpy())
    assert (x_fin.numpy() == 1 << 16).all()

    w_u32 = jnp.asarray(words[:, :cap].numpy().astype(np.uint32))
    s_syms, s_cons, s_fin = jax.vmap(lambda w, c: j_dev.decode(
        w, jnp.asarray(cdfs), c, t_steps=t_steps))(w_u32, jnp.asarray(ctx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(s_syms))
    np.testing.assert_array_equal(cons.numpy(), np.asarray(s_cons))
    np.testing.assert_array_equal(x_fin.numpy().view(np.uint32),
                                  np.asarray(s_fin))
    jw = jnp.asarray(w16.numpy().view(np.uint16))
    p_syms, p_cons, p_fin = pallas_rans.decode_ctx(
        jw, pallas_rans.split_init(jw, n), jnp.asarray(cdfs),
        jnp.asarray(ctx), t_steps=t_steps, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(p_syms))
    np.testing.assert_array_equal(cons.numpy(), np.asarray(p_cons))
    np.testing.assert_array_equal(x_fin.numpy().view(np.uint32),
                                  np.asarray(p_fin))


def test_ctx_wrappers_reject_bad_input(ctx_case):
    cdfs, ctx, syms = ctx_case
    sy, tb, cx = (torch.from_numpy(a) for a in (syms, cdfs, ctx))
    with pytest.raises(ValueError):
        cuda_rans.encode_batch_compact_ctx(sy.to(torch.int8), tb, cx)
    with pytest.raises(ValueError):
        cuda_rans.encode_batch_compact_ctx(sy, tb, cx[:, :-1])
    with pytest.raises(ValueError):
        cuda_rans.encode_batch_compact_ctx(sy, tb.to(torch.int64), cx)
    words, _ = cuda_rans.encode_batch_compact_ctx(sy, tb, cx)
    x0 = cuda_rans.split_init(words, syms.shape[2])
    with pytest.raises(ValueError):
        cuda_rans.decode_ctx(words, x0, tb, cx.to(torch.int64),
                             syms.shape[1])
    with pytest.raises(ValueError):
        cuda_rans.decode_ctx(words, x0, tb, cx, syms.shape[1] + 1)


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

def _integer_case(rng, b=2, size=128, n=128, m=192, y_escapes=6,
                  z_escapes=3):
    """Integer y, z and float32 sigma of a size x size batch, with forced
    out-of-alphabet values."""
    y = np.round(rng.laplace(scale=6.0, size=(b, size // 16, size // 16, m)))
    z = np.round(rng.laplace(scale=3.0, size=(b, size // 64, size // 64, n)))
    y.reshape(-1)[rng.choice(y.size, y_escapes, replace=False)] = 300
    z.reshape(-1)[rng.choice(z.size, z_escapes, replace=False)] = -90
    sigma = np.exp(rng.uniform(np.log(0.05), np.log(300), size=y.shape))
    return y.astype(np.int32), z.astype(np.int32), sigma.astype(np.float32)


def _jax_containers(j_codec, y, z, sigma, size, monkeypatch):
    monkeypatch.setattr(j_codec, "_encode_dev_arrays", lambda x: (
        jnp.asarray(y, jnp.float32), jnp.asarray(z, jnp.float32), None,
        jnp.asarray(sigma)))
    return j_codec.compress_batch(jnp.zeros((y.shape[0], size, size, 3)))


@pytest.mark.parametrize("escapes", [0, 1])
def test_containers_byte_identical(codecs, monkeypatch, escapes):
    j_codec, t_codec = codecs
    rng = np.random.default_rng(20 + escapes)
    y, z, sigma = _integer_case(rng, y_escapes=6 * escapes,
                                z_escapes=3 * escapes)
    ctx = t_codec._scale_ctx(torch.from_numpy(sigma))
    got = t_codec.entropy_encode(torch.from_numpy(y), torch.from_numpy(z),
                                 ctx, 128, 128)
    want = _jax_containers(j_codec, y, z, sigma, 128, monkeypatch)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert g == w
    n_raw = [sum(escape.unpack_raw(container.unpack(g)[1][k])[0].size
                 for g in got) for k in (3, 4)]
    assert n_raw == [3 * escapes, 6 * escapes]


def test_roundtrip_exact(codecs):
    _, t_codec = codecs
    x = torch.from_numpy(np.random.default_rng(4).random(
        (2, 128, 128, 3), np.float32))
    blobs = t_codec.compress_batch(x)
    assert [container.unpack(b)[0] for b in blobs] == [
        container.CODEC_HYPERPRIOR_DEV] * 2
    x_hat, y_hat, z_hat = t_codec.decompress_batch(blobs, return_z=True)
    y, z, _ = t_codec.encode_parts(x)
    np.testing.assert_array_equal(y_hat.numpy(), y.numpy())
    np.testing.assert_array_equal(z_hat.numpy(), z.numpy())
    np.testing.assert_array_equal(
        x_hat.numpy(), t_codec.model.decode_arrays(y_hat).numpy())


def test_roundtrip_with_forced_escapes(trained, monkeypatch):
    """Shrunk alphabets force escapes through the side sections; the
    decoded latents still equal the encoder's integers."""
    monkeypatch.setattr(hyper_codec, "_Y_MAX_DEV", 1)
    monkeypatch.setattr(hyper_codec, "_Z_MAX", 1)
    port = trained[2]
    codec = hyper_codec.HyperCodec(port)
    codec.z_cdfs = hyper_codec.build_factorized_cdfs(port, max_abs=1)
    codec.y_cdfs_dev = hyper_codec.build_gaussian_cdfs(codec.scale_table, 1)
    x = torch.from_numpy(np.random.default_rng(6).random(
        (2, 64, 64, 3), np.float32) * 9.0 - 4.0)
    blobs = codec.compress_batch(x)
    n_raw = [sum(escape.unpack_raw(container.unpack(b)[1][k])[0].size
                 for b in blobs) for k in (3, 4)]
    assert min(n_raw) > 0, n_raw
    _, y_hat, z_hat = codec.decompress_batch(blobs, return_z=True)
    y, z, _ = codec.encode_parts(x)
    np.testing.assert_array_equal(y_hat.numpy(), y.numpy())
    np.testing.assert_array_equal(z_hat.numpy(), z.numpy())


def test_cross_decode_jax_containers(codecs):
    """The port decodes the JAX package's containers to JAX's y_hat, image
    by image wherever the two packages' scale bins agree; positions where
    they differ are counted and printed."""
    j_codec, t_codec = codecs
    x = np.random.default_rng(8).random((2, 128, 128, 3), np.float32)
    blobs = j_codec.compress_batch(jnp.asarray(x))
    j_x, j_y = j_codec.decompress_batch(blobs)
    _, z_hat, _, j_sigma = j_codec._encode_dev_arrays(jnp.asarray(x))
    j_ctx = np.asarray(j_codec._scale_ctx(j_sigma))
    t_ctx = t_codec._scale_ctx(t_codec.model.scales_from_z(
        torch.from_numpy(np.array(z_hat)))).numpy()
    differ = (j_ctx != t_ctx).reshape(len(blobs), -1).sum(1)
    print(f"scale-bin positions that differ per image: {differ.tolist()}")
    agree = [i for i in range(len(blobs)) if differ[i] == 0]
    assert agree, "no image's scale bins agree"
    for i in agree:
        x_hat, y_hat = t_codec.decompress_batch([blobs[i]])
        np.testing.assert_array_equal(y_hat.numpy()[0], np.asarray(j_y)[i])
        np.testing.assert_allclose(x_hat.numpy()[0], np.asarray(j_x)[i],
                                   **TOL)


def test_corrupt_and_foreign_containers_raise(codecs):
    _, t_codec = codecs
    x = torch.from_numpy(np.random.default_rng(9).random(
        (1, 64, 64, 3), np.float32))
    blob = t_codec.compress_batch(x)[0]
    _, sections = container.unpack(blob)
    y_end = len(blob) - len(sections[3]) - len(sections[4])
    bad = bytearray(blob)
    bad[y_end - len(sections[2]) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="corrupt"):
        t_codec.decompress_batch([bytes(bad)])
    with pytest.raises(ValueError):
        t_codec.decompress_batch([container.pack(container.CODEC_INT8,
                                                 sections[:3])])
    with pytest.raises(ValueError):
        t_codec.compress_batch(x[:, :32])


def test_serial_format_and_meanscale_codec_build(codecs, trained):
    """The serial format round-trips: y_hat equals the encoder's rounded y,
    and a container of the other format is refused.  ``MeanScaleCodec``
    builds on the trained mean-scale model, and its ``from_checkpoint``
    refuses this scale checkpoint."""
    _, t_codec = codecs
    x = torch.from_numpy(np.random.default_rng(10).random(
        (1, 64, 64, 3), np.float32))
    data = t_codec.compress(x)
    x_hat, y_hat = t_codec.decompress(data)
    y, _, _ = t_codec.encode_parts(x)
    np.testing.assert_array_equal(y_hat.numpy(), y.numpy())
    assert x_hat.shape == (1, 64, 64, 3)
    with pytest.raises(ValueError):
        t_codec.decompress(t_codec.compress_batch(x)[0])
    with pytest.raises(ValueError):
        t_codec.compress(torch.cat([x, x]))
    ms_ckpt = CKPT.replace("hp_scale_", "hp_meanscale_")
    ms_codec = hyper_codec.MeanScaleCodec(
        hyperprior.MeanScaleHyperprior.from_checkpoint(ms_ckpt, device="cpu"))
    assert ms_codec.z_cdfs.shape == t_codec.z_cdfs.shape
    assert ms_codec.model.h_s.Conv_0.weight.shape[0] == 2 * trained[2].m
    with pytest.raises(ValueError, match="checkpoint"):
        hyper_codec.MeanScaleCodec.from_checkpoint(CKPT, device="cpu")


@pytest.mark.parametrize("n_pix,channels", [(1, 128), (4, 128), (64, 192),
                                            (1536, 192)])
def test_plan_lanes_matches_jax(n_pix, channels):
    assert hyper_codec._plan_lanes(n_pix, channels) == \
        j_hc._plan_lanes(n_pix, channels)


def test_escape_helpers_match_jax():
    from simple_image_compression_network_tpu.codec import escape as j_esc
    rng = np.random.default_rng(12)
    vals = rng.integers(-300, 300, size=500)
    for max_abs in (1, 63, 127):
        np.testing.assert_array_equal(
            escape.to_symbols(torch.from_numpy(vals), max_abs).numpy(),
            np.asarray(j_esc.to_symbols(jnp.asarray(vals), max_abs)))
        raw = escape.pack_raw(vals, max_abs)
        assert raw == j_esc.pack_raw(vals, max_abs)
        back = escape.from_symbols(
            escape.to_symbols(torch.from_numpy(vals), max_abs).numpy(),
            escape.unpack_raw(raw)[0], max_abs)
        np.testing.assert_array_equal(back, vals)
