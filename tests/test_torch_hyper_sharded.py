"""The port's spatially sharded hyperprior codec (``parallel/hyper_sharded.py``)
against the JAX package's ``ShardedHyperCodec`` and the port's single-device
codecs.

The port's ranks are processes on the CPU over gloo (``spawn_ranks``), one
group of each size (2, 4) running every case of that size; the JAX package
runs on ``tests/conftest.py``'s virtual CPU devices in this process.  The
models are the JAX test's (``tests/test_hyper_sharded.py``: n = 16, m = 24,
``jax.random.key(7)``), carried across with ``hyper_params_from_jax``, at
its 1024x1024 images, B = 2: z is 16x16 (S_z = 4 streams), y 64x64 (S_y =
8), so both plans tile over 2 and 4 ranks.

The tiled float layers are held to the whole-image module within 1e-5; the
containers to the JAX package's sharded containers byte for byte, the
symbols compared first off their ties (y, or y - mu, within ``TIE`` of a
half-integer, where an ulp between two frameworks decides the rounding:
counted and asserted); the round trip and cross-decoding to the port's
single-device codec, y_hat exactly and x_hat within 1e-5.  In the group
of 2 the scale model also runs in bf16, against the port's single-device
bf16 codec (x_hat within 2^-7, bf16's spacing below 1).

The spawned ranks import this module, so it imports no JAX at its top: the
JAX package is imported in the fixtures that compute the references."""

import struct

import numpy as np
import pytest
import torch
import torch.distributed as dist

from simple_image_compression_network_tpu_torch.codec import (
    container, cuda_rans, escape, hyper_codec)
from simple_image_compression_network_tpu_torch.models import hyperprior
from simple_image_compression_network_tpu_torch.parallel import (
    distributed, hyper_sharded, mesh as meshlib, spatial)
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

IMG, B, N, M = 1024, 2, 16, 24
# The JAX test's models, and the mean-scale one with seeded noise added to
# the last convs of h_a and h_s ("varied"): at the JAX test's init and
# images z_hat is 0 and h_s's last conv gives 0, so mu = 0 and sigma = 1
# (one scale bin) everywhere; in the varied model z_hat spans [-3, 3] and
# the prior 34 bins that differ from row to row, which each rank's rows of
# the prior must then follow.
MODELS = {"scale": (hyperprior.ScaleHyperprior, hyper_codec.HyperCodec),
          "meanscale": (hyperprior.MeanScaleHyperprior,
                        hyper_codec.MeanScaleCodec),
          "varied": (hyperprior.MeanScaleHyperprior,
                     hyper_codec.MeanScaleCodec)}
JAX_MODELS = ("scale", "meanscale")
TIE = 1e-4
# positions of the 196,608 symbols an image pair within TIE of a half in
# either package (about one in 5,000 is expected; with mu = 0 both models'
# y - mu share their ties): none flips, and the containers compare byte
# for byte
N_TIES = {"scale": 33, "meanscale": 33}
TOL = 1e-5
BF16 = torch.bfloat16
BF16_X_TOL = 2.0 ** -7    # x_hat in [0, 1], as tests/test_torch_bf16.py
SPAWN_S = 180
# one form of each tiled layer kind: (module path, NCHW input shape)
FORMS = {"conv k5/s2": ("g_a.Conv_0", (2, 3, 64, 40)),
         "conv k3/s1": ("h_a.Conv_0", (2, M, 32, 20)),
         "deconv k5/s2": ("g_s.ConvTranspose_0", (2, M, 16, 12))}
ENC = {"rans_encode": 1, "rans_encode_ctx": 1, "rans_decode": 0,
       "rans_decode_ctx": 0}
DEC = {"rans_encode": 0, "rans_encode_ctx": 0, "rans_decode": 1,
       "rans_decode_ctx": 1}


def _images(b: int = B, size: int = IMG) -> np.ndarray:
    """The JAX test's images: 16x16 blocks of seeded colours plus noise."""
    rng = np.random.default_rng(5)
    base = rng.uniform(0.2, 0.8, size=(b, size // 16, size // 16, 3))
    img = np.repeat(np.repeat(base, 16, axis=1), 16, axis=2)
    img += rng.normal(0, 0.02, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _form_input(shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(3).normal(
        size=shape).astype(np.float32))


def _port_model(which: str, state: dict, dtype=torch.float32):
    model = MODELS[which][0](n=N, m=M, device="cpu", dtype=dtype)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _plain_runs() -> dict:
    return {"rans_encode": cuda_rans.encode_batch_compact.plain_runs,
            "rans_encode_ctx": cuda_rans.encode_batch_compact_ctx.plain_runs,
            "rans_decode": cuda_rans.decode.plain_runs,
            "rans_decode_ctx": cuda_rans.decode_ctx.plain_runs}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _plain_runs().items()}


def _primary(value):
    """Only rank 0 sends a gathered array back (all ranks hold it)."""
    return value if dist.get_rank() == 0 else None


def corrupt(blob: bytes) -> bytes:
    """A byte flipped in the middle of the words of the middle y stream of
    a hyper container (the stream of a middle rank)."""
    _, sections = container.unpack(blob)
    y_pay = sections[2]
    off = len(blob) - len(sections[4]) - len(sections[3]) - len(y_pay) + 2
    for _ in range(struct.unpack_from("<H", y_pay)[0] // 2):
        off += 4 + struct.unpack_from("<I", blob, off)[0]
    bad = bytearray(blob)
    bad[off + 4 + struct.unpack_from("<I", blob, off)[0] // 2] ^= 0xFF
    return bytes(bad)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _forms_case(model, mesh) -> dict:
    """Each tiled layer form on this rank's rows, gathered on X."""
    out = {}
    for form, (path, shape) in FORMS.items():
        layer = model.get_submodule(path)
        tile = spatial.shard_image(_form_input(shape).transpose(1, 2),
                                   mesh).transpose(1, 2)
        run = (hyper_sharded.deconv_tile if "deconv" in form
               else hyper_sharded.conv_tile)
        with torch.no_grad():
            got = run(layer, tile.contiguous(), mesh)
        out[form] = _primary(torch.cat(spatial.all_gather(got, mesh),
                                       2).numpy())
    return out


def _codec_case(which: str, state: dict, single: list, mesh) -> dict:
    """compress then decompress (plain runs counted a direction), the
    single-device containers decoded, a corrupt container."""
    codec = MODELS[which][1](_port_model(which, state))
    sharded = hyper_sharded.ShardedHyperCodec(codec, mesh)
    x = torch.from_numpy(_images())
    before = _plain_runs()
    blobs = sharded.compress_batch(x)
    enc = _delta(before)
    before = _plain_runs()
    x_hat, y_hat = sharded.decompress_batch(blobs)
    dec = _delta(before)
    x1, y1 = sharded.decompress_batch(single)
    return {"blobs": blobs, "enc": enc, "dec": dec,
            "routes": dict(sharded.routes), "tile": tuple(y_hat.shape),
            "x_hat": _primary(spatial.gather_image(x_hat, mesh).numpy()),
            "y_hat": _primary(spatial.gather_image(y_hat, mesh).numpy()),
            "x_single": _primary(spatial.gather_image(x1, mesh).numpy()),
            "y_single": _primary(spatial.gather_image(y1, mesh).numpy()),
            "corrupt": _raises(lambda: sharded.decompress_batch(
                [corrupt(blobs[0])] + blobs[1:]))}


def _fallback_case(state: dict, mesh) -> dict:
    """tests/test_hyper_sharded.py's escape batch: the alphabets shrunk to
    1 here, in the rank (a parent's patch does not reach spawned ranks),
    and out-of-gamut input."""
    saved = hyper_codec._Z_MAX, hyper_codec._Y_MAX_DEV
    hyper_codec._Z_MAX = hyper_codec._Y_MAX_DEV = 1
    try:
        codec = hyper_codec.HyperCodec(_port_model("scale", state))
        codec.z_cdfs = hyper_codec.build_factorized_cdfs(codec.model, 1)
        codec.y_cdfs_dev = hyper_codec.build_gaussian_cdfs(
            codec.scale_table, 1)
        sharded = hyper_sharded.ShardedHyperCodec(codec, mesh)
        x = torch.from_numpy(_images(1) * 9.0 - 4.0)
        blobs = sharded.compress_batch(x)
        n_raw = sum(escape.unpack_raw(container.unpack(bl)[1][k])[0].size
                    for bl in blobs for k in (3, 4))
        _, y_hat = sharded.decompress_batch(blobs)
        sym = codec.encode_arrays(x)[0]
        return {"n_raw": n_raw, "same": blobs == codec.compress_batch(x),
                "exact": bool(torch.equal(y_hat, sym.to(torch.float32))),
                "routes": dict(sharded.routes)}
    finally:
        hyper_codec._Z_MAX, hyper_codec._Y_MAX_DEV = saved


def _bf16_case(state: dict, single: list, mesh) -> dict:
    """The scale model in bf16: compress then decompress, and the single-
    device bf16 codec's containers decoded."""
    codec = hyper_codec.HyperCodec(_port_model("scale", state, BF16))
    sharded = hyper_sharded.ShardedHyperCodec(codec, mesh)
    x = torch.from_numpy(_images())
    blobs = sharded.compress_batch(x)
    x_hat, y_hat = sharded.decompress_batch(blobs)
    x1, y1 = sharded.decompress_batch(single)
    return {"blobs": blobs, "routes": dict(sharded.routes),
            **{k: _primary(spatial.gather_image(t, mesh).numpy())
               for k, t in (("x_hat", x_hat), ("y_hat", y_hat),
                            ("x_single", x1), ("y_single", y1))}}


def _ranks_body(states: dict, singles: dict) -> dict:
    """Every case of this group's size, on one rank."""
    torch.set_num_threads(1)
    mesh = meshlib.spatial_mesh(device="cpu")
    model = _port_model("scale", states["scale"])
    out = {"forms": _forms_case(model, mesh),
           "codec": {w: _codec_case(w, states[w], singles[w], mesh)
                     for w in MODELS},
           "fallback": _fallback_case(states["scale"], mesh)}
    if dist.get_world_size() == 2:
        out["bf16"] = _bf16_case(states["scale"], singles["bf16"], mesh)
    sharded = hyper_sharded.ShardedHyperCodec(hyper_codec.HyperCodec(model),
                                              mesh)
    out["refused"] = _raises(lambda: sharded.compress_batch(
        torch.zeros(1, 256, 256, 3)))
    if dist.get_world_size() == 2:
        mesh2 = meshlib.make_mesh((2, 1), ("x", "y"), device="cpu")
        out["not_1d"] = _raises(lambda: hyper_sharded.ShardedHyperCodec(
            sharded.codec, mesh2))
    return out


@pytest.fixture(scope="module")
def refs():
    """Per model: the JAX package's codec and sharded containers on 2 and
    4 devices, its symbols, and the port's state, single-device
    containers, decode and symbols.

    At this random init the two builds' z tables may differ (ROADMAP
    queue 3: float32 sums in other orders move roundings of the untrained
    density): where they do, the JAX codec takes the port's z table before
    it encodes, so the containers compare byte for byte."""
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze
    from simple_image_compression_network_tpu.codec import (
        hyper_codec as j_hc)
    from simple_image_compression_network_tpu.models import (
        hyperprior as j_hp)
    from simple_image_compression_network_tpu.parallel import (
        hyper_sharded as j_hs, mesh as j_mesh)
    x = _images()
    out = {}
    for which in JAX_MODELS:
        j_model = (j_hp.MeanScaleHyperprior if which == "meanscale"
                   else j_hp.ScaleHyperprior)(n=N, m=M)
        key = jax.random.key(7)
        params = jax.jit(j_model.init)(
            key, jnp.zeros((1, 256, 256, 3), jnp.float32),
            key=jax.random.fold_in(key, 1))
        j_codec = (j_hc.MeanScaleCodec if which == "meanscale"
                   else j_hc.HyperCodec)(j_model, params)
        state = {k: v.numpy() for k, v in weights_io.hyper_params_from_jax(
            jax.tree_util.tree_map(np.asarray, unfreeze(params))).items()}
        codec = MODELS[which][1](_port_model(which, state))
        tables_equal = bool(np.array_equal(codec.z_cdfs, j_codec.z_cdfs))
        if not tables_equal:
            j_codec.z_cdfs = codec.z_cdfs
        jx = jnp.asarray(x)
        j_sym, j_z, j_mu, _ = j_codec._encode_dev_arrays(jx)
        j_y = np.asarray(j_codec._analysis_arrays(jx)[0])
        out[which] = {
            **_single(codec, x), "state": state,
            "tables_equal": tables_equal,
            "jax": {n: j_hs.ShardedHyperCodec(
                j_codec, j_mesh.make_mesh((n,), ("x",))).compress_batch(jx)
                for n in (2, 4)},
            "j_sym": np.asarray(j_sym).astype(np.int32),
            "j_z": np.asarray(j_z).astype(np.int32),
            "j_d": j_y - (0 if j_mu is None else np.asarray(j_mu))}
    rng = np.random.default_rng(11)
    state = dict(out["meanscale"]["state"])
    for name, std in (("h_a.Conv_2.weight", 0.5), ("h_s.Conv_0.weight", 0.1),
                      ("h_s.Conv_0.bias", 0.5)):
        state[name] = state[name] + rng.normal(
            0, std, state[name].shape).astype(np.float32)
    out["varied"] = {**_single(MODELS["varied"][1](
        _port_model("varied", state)), x), "state": state}
    out["bf16"] = _single(hyper_codec.HyperCodec(_port_model(
        "scale", out["scale"]["state"], BF16)), x)
    return out


def _single(codec, x: np.ndarray) -> dict:
    """The port's single-device containers and decode of ``x``, and its
    y - mu (y for the scale model)."""
    xt = torch.from_numpy(x)
    blobs = codec.compress_batch(xt)
    x_hat, y_hat = codec.decompress_batch(blobs)
    y = codec.model.analysis_arrays(xt)[0].numpy()
    mu = codec.encode_arrays(xt)[2]
    return {"codec": codec, "blobs": blobs, "x_hat": x_hat.numpy(),
            "y_hat": y_hat.numpy(), "d": y - (0 if mu is None else mu.numpy())}


def _spawn(refs, n: int) -> list:
    states = {w: refs[w]["state"] for w in MODELS}
    singles = {w: refs[w]["blobs"] for w in (*MODELS, "bf16")}
    return distributed.spawn_ranks(_ranks_body, n, backend="gloo",
                                   device="cpu", timeout_s=SPAWN_S,
                                   args=(states, singles))


@pytest.fixture(scope="module")
def group2(refs):
    return _spawn(refs, 2)


@pytest.fixture(scope="module")
def group4(refs):
    return _spawn(refs, 4)


@pytest.fixture
def group(request, ranks):
    """The results of the group of ``ranks`` ranks: one spawn a size, kept
    for the module (a failed spawn fails every test that uses it)."""
    return request.getfixturevalue(f"group{ranks}")


def _ties(d: np.ndarray) -> np.ndarray:
    return np.abs(np.abs(d - np.round(d)) - 0.5) < TIE


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_tiled_layer_matches_the_whole_image_module(refs, ranks, form,
                                                    group):
    """Each conv and deconv form on halo-extended tiles, gathered, against
    the module on the whole input (zeros past the image's ends are the
    layers' own padding)."""
    path, shape = FORMS[form]
    layer = refs["scale"]["codec"].model.get_submodule(path)
    with torch.no_grad():
        whole = layer(_form_input(shape)).numpy()
    got = group[0]["forms"][form]
    assert got.shape == whole.shape
    np.testing.assert_allclose(got, whole, atol=TOL, rtol=0)


@pytest.mark.parametrize("which", JAX_MODELS)
@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_containers_match_jax(refs, ranks, which, group):
    """The symbols that the port's sharded containers carry (decoded by the
    port's single-device codec) equal the JAX package's off the ties
    (counted), z_hat equal; then every rank's containers equal the JAX
    package's ShardedHyperCodec's, byte for byte."""
    r = refs[which]
    blobs = group[0]["codec"][which]["blobs"]
    y_hat, z_hat = (a.numpy() for a in r["codec"].decompress_batch(
        blobs, return_z=True)[1:])
    mu = r["codec"]._prior_from_z(torch.from_numpy(z_hat))[0]
    sym = np.round(y_hat - (0 if mu is None else mu.numpy()))
    ties = _ties(r["d"]) | _ties(r["j_d"])
    assert int(ties.sum()) == N_TIES[which]
    np.testing.assert_array_equal(z_hat.astype(np.int32), r["j_z"])
    np.testing.assert_array_equal(sym[~ties].astype(np.int32),
                                  r["j_sym"][~ties])
    for res in group:
        assert res["codec"][which]["blobs"] == r["jax"][ranks]


@pytest.mark.parametrize("which", sorted(MODELS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_roundtrip(refs, ranks, which, group):
    """The sharded route both ways: the containers equal the port's
    single-device ones, y_hat gathered from the tiles equal to the
    single-device decode's, x_hat within 1e-5; each rank decoded its own
    rows."""
    r, res = refs[which], group[0]["codec"][which]
    assert res["blobs"] == r["blobs"]
    np.testing.assert_array_equal(res["y_hat"], r["y_hat"])
    np.testing.assert_allclose(res["x_hat"], r["x_hat"], atol=TOL, rtol=0)
    for rank in group:
        assert rank["codec"][which]["routes"] == {"sharded": 3,
                                                  "fallback": 0}
        assert rank["codec"][which]["tile"] == (B, IMG // 16 // ranks,
                                                IMG // 16, M)


@pytest.mark.parametrize("which", sorted(MODELS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_cross_decode_with_the_single_device_codec(refs, ranks, which,
                                                   group):
    """The single-device codec decodes the sharded containers, and the
    sharded codec the single-device containers: y_hat exactly, x_hat
    within 1e-5."""
    r, res = refs[which], group[0]["codec"][which]
    x_hat, y_hat = r["codec"].decompress_batch(res["blobs"])
    np.testing.assert_array_equal(y_hat.numpy(), res["y_hat"])
    np.testing.assert_allclose(x_hat.numpy(), res["x_hat"], atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(res["y_single"], r["y_hat"])
    np.testing.assert_allclose(res["x_single"], r["x_hat"], atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("ranks", [2, 4])
def test_escape_batch_falls_back_to_the_single_device_codec(ranks, group):
    """With the alphabets shrunk to 1, out-of-gamut input escapes: both
    directions take the wrapped codec on every rank, the containers carry
    the escapes and are its bytes, and y_hat is its encoder's symbols."""
    for res in group:
        fb = res["fallback"]
        assert fb["n_raw"] > 0
        assert fb["same"] and fb["exact"]
        assert fb["routes"] == {"sharded": 0, "fallback": 2}


@pytest.mark.parametrize("which", sorted(MODELS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_corrupt_container_raises_on_every_rank(ranks, which, group):
    """A byte flipped mid-way through the y streams (a middle rank's
    stream) raises on every rank, through the MIN all-reduce of the
    flags."""
    for res in group:
        assert res["codec"][which]["corrupt"] == "corrupt latent stream"


@pytest.mark.parametrize("ranks", [2, 4])
def test_a_plan_that_does_not_tile_raises_on_every_rank(ranks, group):
    """At 256x256 the z plan has S_z = 1: JAX asserts, the port raises
    ValueError on every rank before any collective."""
    for res in group:
        assert res["refused"] == (f"z stream plan S=1, rows=4 does not "
                                  f"tile over {ranks} ranks")


@pytest.mark.parametrize("which", sorted(MODELS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_each_rank_runs_b_and_d_an_encode_c_and_e_a_decode(ranks, which,
                                                           group):
    """Per rank, the plain versions that stand for the kernels on the CPU:
    B and D once an encode, C and E once a decode (the counts the card's
    run gates on launches)."""
    for res in group:
        assert res["codec"][which]["enc"] == ENC
        assert res["codec"][which]["dec"] == DEC


def test_the_mesh_must_be_one_dimensional(group2):
    assert group2[0]["not_1d"] == ("ShardedHyperCodec tiles X over a 1-D "
                                   "mesh named 'x', not ('x', 'y')")


def test_the_varied_prior_spreads_mu_and_the_scale_bins(refs):
    """The precondition of the "varied" cases: z_hat not all 0, mu away
    from 0 and many scale bins, differing between the 4 ranks' rows."""
    codec = refs["varied"]["codec"]
    _, z, mu, sigma = codec.encode_arrays(torch.from_numpy(_images()))
    ctx = codec._scale_ctx(sigma)
    assert float((z != 0).float().mean()) > 0.5
    assert float(mu.abs().max()) > 0.5
    assert ctx.unique().numel() >= 30
    rows = ctx.shape[1] // 4
    for r in range(1, 4):
        assert not torch.equal(ctx[:, :rows], ctx[:, r * rows:(r + 1) * rows])


def test_bf16_scale_model_cross_decodes_with_the_single_device_codec(
        refs, group2):
    """The scale model in bf16 on 2 ranks: its containers and the single-
    device bf16 codec's decode under each other with y_hat exactly the
    symbols, x_hat within bf16's 2^-7 of the single-device decode's; the
    containers are byte-identical (every tile conv of g_a and h_a sums as
    the whole image's, so no symbol differs)."""
    r, res = refs["bf16"], group2[0]["bf16"]
    assert res["routes"] == {"sharded": 3, "fallback": 0}
    x_hat, y_hat = r["codec"].decompress_batch(res["blobs"])
    np.testing.assert_array_equal(y_hat.numpy(), res["y_hat"])
    np.testing.assert_allclose(x_hat.numpy(), res["x_hat"], atol=BF16_X_TOL,
                               rtol=0)
    np.testing.assert_array_equal(res["y_single"], r["y_hat"])
    np.testing.assert_allclose(res["x_single"], r["x_hat"], atol=BF16_X_TOL,
                               rtol=0)
    np.testing.assert_allclose(res["x_hat"], r["x_hat"], atol=BF16_X_TOL,
                               rtol=0)
    n_diff = int((res["y_hat"] != r["y_hat"]).sum())
    assert n_diff == 0
    assert res["blobs"] == r["blobs"]
