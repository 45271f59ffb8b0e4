"""The port's spatially sharded int8 codec (``parallel/``) against the JAX
package's, bit for bit.

The port's ranks are processes on the CPU over gloo (``spawn_ranks``), one
group of each size running every case of that size; the JAX package runs on
``tests/conftest.py``'s 8 virtual CPU devices in this process.  Every
comparison is exact: halo rows, the gathered transforms, the CDF tables,
the stream words and counts, and the container bytes.

The spawned ranks import this module, so it imports no JAX at its top: the
JAX package is imported in the fixtures that compute the references."""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from simple_image_compression_network_tpu_torch.codec import (
    cuda_rans, int_codec)
from simple_image_compression_network_tpu_torch.config import (
    reference_net_for_input)
from simple_image_compression_network_tpu_torch.models import codec_int
from simple_image_compression_network_tpu_torch.ops import cuda_conv
from simple_image_compression_network_tpu_torch.parallel import (
    distributed, entropy_sharded, mesh as meshlib, spatial)
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CKPT = os.path.join(ROOT, "checkpoints", "reference_weights.npz")
CDFS = os.path.join(ROOT, "checkpoints", "latent_cdfs.npz")
PLANS = {"s2d": None, "pallas3": ("pallas3",) * 4 + ("pd2s3",) * 4}
# (ranks, mesh shape, axis names, image X, Y): the JAX tests' geometries
NETS = [(2, (2,), ("x",), 32, 32), (4, (4,), ("x",), 64, 32),
        (4, (2, 2), ("x", "y"), 64, 64)]
CODEC_B, CODEC_X, CODEC_Y = 2, 256, 256      # S = 4 streams an image
N_DEV, S_LOCAL, LANE_MULT = 4, 2, 1          # tests/test_entropy_sharded.py
SPAWN_S = 120


def _image(seed: int, b: int, xd: int, yd: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(b, xd, yd, 3),
                                                dtype=np.uint8)


def _entropy_image() -> np.ndarray:
    """The JAX entropy test's batch: (2, 128, 64, 3) from seed 11."""
    return _image(11, 2, 128, 64)


def _kernel_counts() -> dict:
    return {"conv3x3_s1_int8": cuda_conv.conv3x3_s1_int8.plain_runs,
            "conv_sparse_int8": cuda_conv.conv_sparse_int8.plain_runs,
            "rans_encode": cuda_rans.encode_batch_compact.plain_runs,
            "rans_decode": cuda_rans.decode.plain_runs}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _kernel_counts().items()}


def _primary(value):
    """Only rank 0 sends a gathered array back (all ranks hold it)."""
    return value if dist.get_rank() == 0 else None


def _net_cases(params: dict, n: int) -> dict:
    out = {}
    for ranks, shape, axes, xd, yd in NETS:
        if ranks != n:
            continue
        mesh = meshlib.make_mesh(shape, axes, device="cpu")
        x = torch.from_numpy(_image(3, 1, xd, yd))
        cfg = reference_net_for_input(xd, yd)
        for name, impl in PLANS.items():
            y = spatial.eight_layers_net_sharded(
                params, spatial.shard_image(x, mesh, axes), mesh, cfg, axes,
                impl)
            out[(shape, name)] = _primary(
                spatial.gather_image(y, mesh, axes).numpy())
    return out


def _halo_case() -> dict:
    """tests/test_spatial.py's halo input: (1, 32, 2, 1) over 4 ranks; the
    extended tiles gathered (1, 48, 2, 1); and on a (4, 1) mesh the
    one-rank Y axis, a zero pad."""
    x = torch.arange(64, dtype=torch.int8).reshape(1, 32, 2, 1)
    mesh = meshlib.spatial_mesh(4, device="cpu")
    ext = spatial.halo_exchange_x(spatial.shard_image(x, mesh), 2, mesh)
    mesh2 = meshlib.make_mesh((4, 1), ("x", "y"), device="cpu")
    tile = spatial.shard_image(x, mesh2, ("x", "y"))
    return {"halo": _primary(spatial.gather_image(ext, mesh).numpy()),
            "pad_y": spatial.halo_exchange(tile, 1, mesh2, "y", 2).numpy(),
            "tile": tile.numpy(), "neighbours": mesh2.neighbours("x"),
            "coords": meshlib.make_mesh((2, 2), ("x", "y"),
                                        device="cpu").coords()}


def _entropy_case(params: dict) -> dict:
    """tests/test_entropy_sharded.py's setup on 4 ranks: the CDFs from the
    all-reduced counts, each rank's streams, then decode of the streams
    gathered and cut again (``shard_streams``)."""
    cfg = reference_net_for_input(128, 64)
    mesh = meshlib.spatial_mesh(N_DEV, device="cpu")
    tile = spatial.shard_image(torch.from_numpy(_entropy_image()), mesh)
    cdfs = entropy_sharded.build_static_cdfs_sharded(params, tile, mesh, cfg)
    n_lanes = LANE_MULT * 192
    lane_cdf = torch.from_numpy(np.ascontiguousarray(
        int_codec._lane_cdf(cdfs, n_lanes), np.int32))
    words, counts = entropy_sharded.compress_sharded(
        params, tile, mesh, lane_cdf, cfg, s_local=S_LOCAL,
        lane_mult=LANE_MULT)
    all_w = entropy_sharded._all_gather(words, mesh)
    all_c = entropy_sharded._all_gather(counts, mesh)
    b = words.shape[0]
    glob_w = all_w.transpose(1, 0, 2, 3).reshape(b, N_DEV * S_LOCAL, -1)
    glob_c = all_c.transpose(1, 0, 2).reshape(b, N_DEV * S_LOCAL)
    w_loc, c_loc = entropy_sharded.shard_streams(glob_w.view(np.uint16),
                                                 glob_c, mesh)
    t_steps = 8 * 4 // LANE_MULT // (N_DEV * S_LOCAL)
    x_hat, z, ok = entropy_sharded.decompress_sharded(
        params, w_loc, c_loc, mesh, lane_cdf, (128, 64), cfg,
        t_steps=t_steps)
    return {"cdfs": cdfs, "words": _primary(glob_w.view(np.uint16)),
            "counts": _primary(glob_c), "ok": ok.numpy(),
            "x_hat": _primary(spatial.gather_image(x_hat, mesh).numpy()),
            "z": _primary(spatial.gather_image(z, mesh).numpy()),
            "own": (words.numpy(), counts.numpy())}


def _codec_case(n: int) -> dict:
    """ShardedIntCodec at 256x256, B = 2: containers, the decoded tiles
    gathered, each direction's plain kernel runs, and a corrupt
    container."""
    mesh = meshlib.spatial_mesh(n, device="cpu")
    net = codec_int.IntCodecNet.from_checkpoint(CKPT, device="cpu")
    codec = entropy_sharded.ShardedIntCodec(
        net, weights_io.load_static_cdfs(CDFS), mesh,
        reference_net_for_input(CODEC_X, CODEC_Y))
    x = torch.from_numpy(_image(9, CODEC_B, CODEC_X, CODEC_Y))
    before = _kernel_counts()
    blobs = codec.compress_batch(x)
    enc = _delta(before)
    before = _kernel_counts()
    x_hat, z = codec.decompress_batch(blobs)
    dec = _delta(before)
    if codec._tiles(CODEC_X, CODEC_Y):
        x_hat = spatial.gather_image(x_hat, mesh)
    bad = bytearray(blobs[0])
    bad[-3] ^= 0xFF
    try:
        codec.decompress_batch([bytes(bad)] + blobs[1:])
        corrupt = None
    except ValueError as e:
        corrupt = str(e)
    return {"blobs": blobs, "x_hat": _primary(x_hat.numpy()), "enc": enc,
            "dec": dec, "routes": dict(codec.routes), "corrupt": corrupt,
            "tile": tuple(z.shape)}


def _ranks_body() -> dict:
    """Every case of this group's size, on one rank."""
    torch.set_num_threads(1)
    n = dist.get_world_size()
    params = weights_io.params_from_jax(weights_io.load_checkpoint(CKPT))
    out = {"nets": _net_cases(params, n), "codec": _codec_case(n)}
    if n == 4:
        out["halo"] = _halo_case()
        out["entropy"] = _entropy_case(params)
    if n == 2:
        try:
            meshlib.make_mesh((4,), ("x",), device="cpu")
        except ValueError as e:
            out["too_few"] = str(e)
    return out


def _spawn(n: int) -> list:
    return distributed.spawn_ranks(_ranks_body, n, backend="gloo",
                                   device="cpu", timeout_s=SPAWN_S)


@pytest.fixture(scope="module")
def group2():
    return _spawn(2)


@pytest.fixture(scope="module")
def group3():
    return _spawn(3)


@pytest.fixture(scope="module")
def group4():
    return _spawn(4)


@pytest.fixture
def group(request, ranks):
    """The results of the group of ``ranks`` ranks: one spawn a size, kept
    for the module (a failed spawn fails every test that uses it)."""
    return request.getfixturevalue(f"group{ranks}")


@pytest.fixture(scope="module")
def jax_params():
    import jax.numpy as jnp
    from simple_image_compression_network_tpu.utils import weights_io as j_io
    return {k: jnp.asarray(v) for k, v in j_io.load_checkpoint(CKPT).items()}


@pytest.fixture(scope="module")
def port_net():
    return codec_int.IntCodecNet.from_checkpoint(CKPT, device="cpu")


def _jax_mesh(shape, axes):
    from simple_image_compression_network_tpu.parallel import mesh as j_mesh
    return j_mesh.make_mesh(shape, axes)


def test_halo_exchange_matches_jax(group4):
    """4 ranks: each tile's neighbours' rows, and zeros at both ends, as
    the JAX package's ``halo_exchange_x`` under ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from simple_image_compression_network_tpu.parallel import (
        spatial as j_spatial)
    x = jnp.arange(64, dtype=jnp.int8).reshape(1, 32, 2, 1)
    ref = jax.shard_map(lambda h: j_spatial.halo_exchange_x(h, 2),
                        mesh=_jax_mesh((4,), ("x",)),
                        in_specs=P(None, "x", None, None),
                        out_specs=P(None, "x", None, None))(x)
    got = group4[0]["halo"]["halo"]
    assert got.shape == (1, 48, 2, 1)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got[0, :2], 0)
    np.testing.assert_array_equal(got[0, -2:], 0)
    np.testing.assert_array_equal(got[0, 12:14], np.asarray(x)[0, 6:8])


def test_halo_on_a_one_rank_axis_is_a_zero_pad_and_the_mesh_is_row_major(
        group4):
    for rank, res in enumerate(group4):
        h = res["halo"]
        np.testing.assert_array_equal(h["pad_y"][:, :, 1:-1], h["tile"])
        assert not h["pad_y"][:, :, [0, -1]].any()
        assert h["neighbours"] == (rank - 1 if rank else None,
                                   rank + 1 if rank < 3 else None)
        assert h["coords"] == (rank // 2, rank % 2)


@pytest.fixture(scope="module")
def net_refs(jax_params):
    """Per geometry: the JAX package's sharded net (jitted) and the port's
    single-device ``eight_layers_net``, on the same image."""
    import jax
    from simple_image_compression_network_tpu.config import (
        reference_net_for_input as j_geometry)
    from simple_image_compression_network_tpu.parallel import (
        spatial as j_spatial)
    params = weights_io.params_from_jax(weights_io.load_checkpoint(CKPT))
    refs = {}
    for _, shape, axes, xd, yd in NETS:
        x = _image(3, 1, xd, yd)
        mesh = _jax_mesh(shape, axes)
        fn = jax.jit(functools.partial(j_spatial.eight_layers_net_sharded,
                                       mesh=mesh, cfg=j_geometry(xd, yd),
                                       axis_names=axes))
        jx = np.asarray(fn(jax_params, j_spatial.shard_image(
            jax.numpy.asarray(x.view(np.int8)), mesh, axes)))
        port = codec_int.eight_layers_net(
            params, torch.from_numpy(x), reference_net_for_input(xd, yd))
        refs[shape] = (jx, port.numpy())
    return refs


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("ranks,shape", [(n, s) for n, s, *_ in NETS],
                         ids=["2", "4", "2x2"])
def test_sharded_net_matches_jax(net_refs, ranks, shape, plan, group):
    """The gathered tiles == the JAX package's sharded net == the port's
    single-device net, under the default plan (kernel A) and pallas3
    (kernel F)."""
    jx, port = net_refs[shape]
    np.testing.assert_array_equal(jx, port)
    np.testing.assert_array_equal(group[0]["nets"][(shape, plan)],
                                  jx)


@pytest.fixture(scope="module")
def entropy_refs(jax_params):
    """The JAX entropy test's setup: its psum CDFs, its sharded streams on
    4 devices (S_LOCAL = 2, LANE_MULT = 1) and their sharded decode."""
    import jax.numpy as jnp
    from simple_image_compression_network_tpu.codec import (
        int_codec as j_codec)
    from simple_image_compression_network_tpu.config import (
        reference_net_for_input as j_geometry)
    from simple_image_compression_network_tpu.parallel import (
        entropy_sharded as j_ent, spatial as j_spatial)
    cfg = j_geometry(128, 64)
    mesh = _jax_mesh((N_DEV,), ("x",))
    xs = j_spatial.shard_image(jnp.asarray(_entropy_image().view(np.int8)),
                               mesh)
    cdfs = j_ent.build_static_cdfs_sharded(jax_params, xs, mesh, cfg)
    lane_cdf = jnp.asarray(j_codec._lane_cdf(cdfs, LANE_MULT * 192))
    words, counts = j_ent.compress_sharded(
        jax_params, xs, mesh, lane_cdf, cfg, s_local=S_LOCAL,
        lane_mult=LANE_MULT)
    t_steps = 8 * 4 // LANE_MULT // (N_DEV * S_LOCAL)
    x_hat, z, ok = j_ent.decompress_sharded(
        jax_params, words, counts, mesh, lane_cdf, (128, 64), cfg,
        t_steps=t_steps)
    return {"cdfs": cdfs, "words": np.asarray(words),
            "counts": np.asarray(counts), "x_hat": np.asarray(x_hat),
            "z": np.asarray(z), "ok": np.asarray(ok)}


def test_build_static_cdfs_sharded_matches_jax(entropy_refs, group4):
    """The all-reduced counts give the JAX package's psum tables, on every
    rank."""
    for res in group4:
        np.testing.assert_array_equal(res["entropy"]["cdfs"],
                                      entropy_refs["cdfs"])


def test_compress_sharded_words_and_counts_match_jax(entropy_refs, group4):
    """Each rank's streams are its share of the JAX package's: counts
    equal, and words equal over each stream's count."""
    got = group4[0]["entropy"]
    np.testing.assert_array_equal(got["counts"], entropy_refs["counts"])
    for i, j in np.ndindex(*got["counts"].shape):
        k = int(got["counts"][i, j])
        np.testing.assert_array_equal(got["words"][i, j, :k],
                                      entropy_refs["words"][i, j, :k])
    for rank, res in enumerate(group4):
        w, c = res["entropy"]["own"]
        part = slice(rank * S_LOCAL, (rank + 1) * S_LOCAL)
        np.testing.assert_array_equal(c, entropy_refs["counts"][:, part])


def test_decompress_sharded_matches_jax(entropy_refs, group4):
    got = group4[0]["entropy"]
    assert all(res["entropy"]["ok"].all() for res in group4)
    assert entropy_refs["ok"].all()
    np.testing.assert_array_equal(got["z"], entropy_refs["z"])
    np.testing.assert_array_equal(got["x_hat"], entropy_refs["x_hat"])


@pytest.fixture(scope="module")
def codec_refs(jax_params, port_net):
    """At 256x256, B = 2: the JAX package's ShardedIntCodec on 2 and 4
    devices, the port's single-device containers and net."""
    import jax.numpy as jnp
    from simple_image_compression_network_tpu.config import (
        reference_net_for_input as j_geometry)
    from simple_image_compression_network_tpu.parallel import (
        entropy_sharded as j_ent)
    cdfs = weights_io.load_static_cdfs(CDFS)
    x = _image(9, CODEC_B, CODEC_X, CODEC_Y)
    jx = jnp.asarray(x.view(np.int8))
    jax_blobs = {n: j_ent.ShardedIntCodec(
        jax_params, cdfs, _jax_mesh((n,), ("x",)),
        j_geometry(CODEC_X, CODEC_Y)).compress_batch(jx) for n in (2, 4)}
    xt = torch.from_numpy(x)
    return {"jax": jax_blobs,
            "single": int_codec.compress_batch(port_net, xt, cdfs),
            "x_hat": port_net(xt).numpy()}


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_int_codec_bytes(codec_refs, ranks, group):
    """Every rank's containers == the JAX package's sharded containers ==
    the port's single-device ``compress_batch``, through the sharded
    route."""
    assert codec_refs["jax"][ranks] == codec_refs["single"]
    for res in group:
        assert res["codec"]["blobs"] == codec_refs["single"]
        assert res["codec"]["routes"] == {"sharded": 3, "fallback": 0}


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_int_codec_roundtrip(codec_refs, ranks, group):
    """The gathered x_hat == the single-device net; each rank decoded its
    own latent tile."""
    np.testing.assert_array_equal(group[0]["codec"]["x_hat"],
                                  codec_refs["x_hat"])
    for res in group:
        assert res["codec"]["tile"] == (CODEC_B, CODEC_X // 16 // ranks,
                                        CODEC_Y // 16, 192)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_int_codec_corrupt_raises_on_every_rank(ranks, group):
    """One flipped byte in the last stream (on the last rank) raises
    ValueError on every rank."""
    for res in group:
        assert res["codec"]["corrupt"] == "corrupt stream in sharded decode"


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_int_codec_runs_each_kernel_once_a_layer(ranks, group):
    """Per rank: kernel A's plain version a layer, B's once per encode,
    C's once per decode (the counts the card's run gates on launches)."""
    for res in group:
        assert res["codec"]["enc"] == {"conv3x3_s1_int8": 4,
                                       "conv_sparse_int8": 0,
                                       "rans_encode": 1, "rans_decode": 0}
        assert res["codec"]["dec"] == {"conv3x3_s1_int8": 4,
                                       "conv_sparse_int8": 0,
                                       "rans_encode": 0, "rans_decode": 1}


def test_sharded_int_codec_falls_back_at_three_ranks(codec_refs, group3):
    """S = 4 streams do not tile over 3 ranks: both directions take the
    single-device codec, counted, with the same containers and the whole
    reconstruction on every rank."""
    for res in group3:
        assert res["codec"]["routes"] == {"sharded": 0, "fallback": 3}
        assert res["codec"]["blobs"] == codec_refs["single"]
    np.testing.assert_array_equal(group3[0]["codec"]["x_hat"],
                                  codec_refs["x_hat"])
    assert group3[0]["codec"]["corrupt"].startswith("corrupt stream")


def test_make_mesh_needs_every_rank_and_a_group(group2):
    assert group2[0]["too_few"] == "need 4 ranks, have 2"
    with pytest.raises(RuntimeError, match="no process group"):
        meshlib.make_mesh((1,), ("x",), device="cpu")
