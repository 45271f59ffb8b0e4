"""The port's int8 codec end to end against the JAX package, on the CPU:
the transform with the reference weights, byte-identical containers with
the static CDFs, decoding across the two packages, corrupt streams."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_image_compression_network_tpu.codec import int_codec as j_codec
from simple_image_compression_network_tpu.config import reference_net_for_input
from simple_image_compression_network_tpu.models import codec_int as j_net
from simple_image_compression_network_tpu.utils import weights_io as j_io
from simple_image_compression_network_tpu_torch.codec import container
from simple_image_compression_network_tpu_torch.codec import int_codec
from simple_image_compression_network_tpu_torch.models import codec_int
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
GEOMETRIES = [(64, 64), (96, 64)]


@pytest.fixture(scope="module")
def params():
    return j_io.load_checkpoint(os.path.join(CKPT, "reference_weights.npz"))


@pytest.fixture(scope="module")
def cdfs():
    return weights_io.load_static_cdfs(os.path.join(CKPT, "latent_cdfs.npz"))


@pytest.fixture(scope="module")
def net(params):
    return codec_int.IntCodecNet(weights_io.params_from_jax(params),
                                 device="cpu")


@pytest.fixture(scope="module", params=GEOMETRIES,
                ids=lambda g: f"{g[0]}x{g[1]}")
def case(request, params, cdfs):
    """Two seeded images of one geometry with the JAX package's outputs."""
    xd, yd = request.param
    rng = np.random.default_rng(xd * 1000 + yd)
    x = rng.integers(0, 256, size=(2, xd, yd, 3), dtype=np.uint8)
    cfg = reference_net_for_input(xd, yd)
    xj = jnp.asarray(x.view(np.int8))
    z = np.asarray(j_net.analysis_int8(params, xj, cfg))
    x_hat = np.asarray(j_net.synthesis_int8(params, jnp.asarray(z), cfg))
    blobs = j_codec.compress_batch(params, xj, cfg, static_cdfs=cdfs,
                                   coder="device")
    return x, cfg, z, x_hat, blobs


def test_transform_matches_jax(case, net, params):
    x, cfg, z, x_hat, _ = case
    xt = torch.from_numpy(x)
    zt = net.analysis(xt)
    np.testing.assert_array_equal(zt.numpy(), z)
    np.testing.assert_array_equal(net.synthesis(zt).numpy(), x_hat)
    tp = weights_io.params_from_jax(params)
    for plan in (codec_int.DEFAULT_PLAN, codec_int.GOLDEN_PLAN):
        got = codec_int.eight_layers_net(tp, xt, cfg, impl=plan)
        np.testing.assert_array_equal(got.numpy(), x_hat)


def test_containers_byte_identical(case, net, cdfs):
    x, _, _, _, blobs = case
    ours = int_codec.compress_batch(net, torch.from_numpy(x),
                                    static_cdfs=cdfs)
    assert len(ours) == len(blobs)
    assert all(a == b for a, b in zip(ours, blobs))


def test_containers_cross_decode(case, net, params, cdfs):
    x, _, z, x_hat, blobs = case
    xh, zh = int_codec.decompress_batch(net, blobs, static_cdfs=cdfs)
    np.testing.assert_array_equal(zh.numpy(), z)
    np.testing.assert_array_equal(xh.numpy(), x_hat)
    ours = int_codec.compress_batch(net, torch.from_numpy(x),
                                    static_cdfs=cdfs)
    xj, zj = j_codec.decompress_batch(params, ours, static_cdfs=cdfs,
                                      coder="device")
    np.testing.assert_array_equal(np.asarray(zj), z)
    np.testing.assert_array_equal(np.asarray(xj), x_hat)


def test_corrupt_stream_raises_in_both(case, net, params, cdfs):
    _, _, _, _, blobs = case
    bad = bytearray(blobs[1])
    bad[-3] ^= 0xFF
    corrupt = [blobs[0], bytes(bad)]
    with pytest.raises(ValueError):
        int_codec.decompress_batch(net, corrupt, static_cdfs=cdfs)
    with pytest.raises(ValueError):
        j_codec.decompress_batch(params, corrupt, static_cdfs=cdfs,
                                 coder="device")


def test_single_image_wrappers_and_stats(case, net, cdfs):
    x, _, z, x_hat, blobs = case
    data = int_codec.compress(net, torch.from_numpy(x[:1]), cdfs)
    assert data == blobs[0]
    xh, zh = int_codec.decompress(net, data, cdfs)
    np.testing.assert_array_equal(xh.numpy(), x_hat[:1])
    assert int_codec.compression_stats(x.shape, data) == \
        j_codec.compression_stats(x.shape, data)


@pytest.mark.parametrize("n_pix", [16, 24, 96, 1536, 1537])
def test_plan_streams_matches_jax(n_pix):
    assert int_codec.plan_streams(n_pix) == j_codec.plan_streams(n_pix)


def test_unported_coders_raise(net, cdfs):
    """Every coder of the JAX package is ported: an unknown coder name
    raises ValueError, and a container that embeds its tables decodes on
    every coder, to the latent that the device coder's container gives."""
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, size=(1, 64, 64, 3), dtype=np.uint8))
    for bad in ("cuda", "Native", ""):
        with pytest.raises(ValueError, match="unknown coder"):
            int_codec.compress_batch(net, x, static_cdfs=cdfs, coder=bad)
        with pytest.raises(ValueError, match="unknown coder"):
            int_codec.decompress_batch(net, [b""], coder=bad)
    with_tables = int_codec.compress_batch(net, x)
    _, z = int_codec.decompress_batch(
        net, int_codec.compress_batch(net, x, static_cdfs=cdfs),
        static_cdfs=cdfs)
    for coder in int_codec.CODERS:
        _, z_hat = int_codec.decompress_batch(net, with_tables, coder=coder)
        assert torch.equal(z_hat, z)
    with pytest.raises(ValueError, match="static tables"):
        int_codec.decompress_batch(
            net, int_codec.compress_batch(net, x, static_cdfs=cdfs))


def test_lane_tables_of_two_codecs_stay_cached(net, cdfs):
    """Two static tables used in turn: the containers stay byte-identical
    with the native coder's, and once both are uploaded the second pass
    makes no new lane table."""
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, size=(2, 64, 64, 3), dtype=np.uint8))
    z = net.analysis(x).numpy()
    other = int_codec._histogram_cdfs(z)
    tables = (cdfs, other)
    ref = [int_codec.compress_batch(net, x, static_cdfs=t, coder="native")
           for t in tables]
    for turn in range(2):
        misses = int_codec._lane_cdf_tensor.misses
        for t, want in zip(tables, ref):
            blobs = int_codec.compress_batch(net, x, static_cdfs=t)
            assert blobs == want
            _, z_hat = int_codec.decompress_batch(net, blobs, static_cdfs=t)
            np.testing.assert_array_equal(z_hat.numpy(), z)
        if turn:
            assert int_codec._lane_cdf_tensor.misses == misses


def test_container_matches_jax():
    from simple_image_compression_network_tpu.codec import container as jc
    secs = [b"abc", b"", b"\x00" * 100]
    data = container.pack(container.CODEC_INT8, secs)
    assert data == jc.pack(jc.CODEC_INT8, secs)
    assert container.unpack(data) == jc.unpack(data)
    with pytest.raises(ValueError):
        container.unpack(b"XXXX" + data[4:])
