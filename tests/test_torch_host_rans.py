"""The port's host rANS coders against the JAX package's, on the CPU: the
native library (the port's own g++ build), the serial and interleaved
coders and their Python goldens, the stream helpers, the per-image
histogram tables and the containers that embed them, the shipped Haar
tables on the device coder's plain version against the native coder, and
the serial hyperprior format.  Every comparison is exact: bytes, integers,
uint8 pixels."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu.codec import device_rans as j_dev
from simple_image_compression_network_tpu.codec import entropy as j_ent
from simple_image_compression_network_tpu.codec import hyper_codec as j_hc
from simple_image_compression_network_tpu.codec import ilrans as j_il
from simple_image_compression_network_tpu.codec import int_codec as j_codec
from simple_image_compression_network_tpu.codec import rans as j_rans
from simple_image_compression_network_tpu.config import reference_net_for_input
from simple_image_compression_network_tpu.models import hyperprior as j_hp
from simple_image_compression_network_tpu.utils import weights_io as j_io
from simple_image_compression_network_tpu_torch.codec import (
    container, device_rans, entropy, hyper_codec, ilrans, int_codec, rans,
    wavelet_codec)
from simple_image_compression_network_tpu_torch.models import (
    codec_int, hyperprior)
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CKPT = os.path.join(ROOT, "checkpoints")
CODERS = ["native", "golden"]


def _tables(rng, rows: int, n_syms: int) -> np.ndarray:
    return np.stack([entropy.quantize_cdf(rng.dirichlet(np.ones(n_syms)
                                                        * 0.5))
                     for _ in range(rows)])


def test_native_library_builds_with_gpp():
    path, _ = rans.build()
    assert path.startswith(os.path.join(ROOT, "build", "torch_host") + os.sep)
    assert os.path.basename(path) == "librans.so"
    lib = rans.load_native()
    assert lib is rans.load_native()
    for name in ("rans_encode", "rans_decode", "ilrans_encode",
                 "ilrans_decode"):
        assert getattr(lib, name).argtypes


@pytest.mark.parametrize("coder", CODERS)
def test_serial_coder_matches_jax(coder):
    """Escapes with 32-bit raw values (extremes and negatives included)."""
    rng = np.random.default_rng(1)
    n_syms = 24
    cdf = _tables(rng, 5, n_syms)
    n = 3000
    ctx = rng.integers(0, 5, n)
    syms = rng.integers(0, n_syms - 1, n)
    raw = np.zeros(n, np.int64)
    esc = rng.choice(n, 40, replace=False)
    syms[esc] = n_syms - 1
    raw[esc] = rng.integers(-2 ** 31, 2 ** 31, 40)
    raw[esc[:4]] = [-2 ** 31, 2 ** 31 - 1, -1, 0]
    use_native = coder == "native"
    data = rans.encode(syms, ctx, cdf, raw=raw, use_native=use_native)
    assert data == j_rans.encode(syms, ctx, cdf, raw=raw, use_native=False)
    assert data == j_rans.encode(syms, ctx, cdf, raw=raw)
    got, got_raw = rans.decode(data, n, ctx, cdf, use_native=use_native)
    np.testing.assert_array_equal(got, syms)
    np.testing.assert_array_equal(got_raw[esc], raw[esc])
    ref, ref_raw = j_rans.decode(data, n, ctx, cdf)
    np.testing.assert_array_equal(got_raw, ref_raw)


@pytest.mark.parametrize("coder", CODERS)
@pytest.mark.parametrize("n,lanes", [(0, 8), (1, 8), (1000, 32),
                                     (1003, 32), (4096, 384)])
def test_interleaved_coder_matches_jax(coder, n, lanes):
    rng = np.random.default_rng(n + lanes)
    cdf = _tables(rng, 6, 40)
    ctx = rng.integers(0, 6, n)
    syms = rng.integers(0, 39, n)
    use_native = coder == "native"
    data = rans.encode_interleaved(syms, ctx, cdf, n_lanes=lanes,
                                   use_native=use_native)
    assert data == j_rans.encode_interleaved(syms, ctx, cdf, n_lanes=lanes)
    assert data == j_il.encode(syms, ctx, cdf, lanes)
    np.testing.assert_array_equal(
        rans.decode_interleaved(data, ctx, cdf, use_native=use_native), syms)


def test_ilrans_golden_matches_jax():
    rng = np.random.default_rng(2)
    cdf = _tables(rng, 3, 20)
    for n, lanes in ((777, 16), (64, 64), (5, 192)):
        ctx = rng.integers(0, 3, n)
        syms = rng.integers(0, 19, n)
        data = ilrans.encode(syms, ctx, cdf, lanes)
        assert data == j_il.encode(syms, ctx, cdf, lanes)
        np.testing.assert_array_equal(ilrans.decode(data, ctx, cdf),
                                      j_il.decode(data, ctx, cdf))
        s2, c2 = ilrans.pad_to_lanes(syms, ctx, lanes)
        r2 = j_il.pad_to_lanes(syms, ctx, lanes)
        np.testing.assert_array_equal(s2, r2[0])
        np.testing.assert_array_equal(c2, r2[1])
        np.testing.assert_array_equal(ilrans.pad_ctx(ctx, lanes),
                                      j_il.pad_ctx(ctx, lanes))


@pytest.mark.parametrize("coder", CODERS)
def test_corrupt_streams_raise(coder):
    rng = np.random.default_rng(3)
    cdf = _tables(rng, 2, 16)
    ctx = rng.integers(0, 2, 500)
    syms = rng.integers(0, 15, 500)
    use_native = coder == "native"
    data = bytearray(rans.encode_interleaved(syms, ctx, cdf, n_lanes=16))
    data[-5] ^= 0x5A
    with pytest.raises(ValueError):
        rans.decode_interleaved(bytes(data), ctx, cdf, use_native=use_native)
    with pytest.raises(ValueError):
        rans.decode_interleaved(bytes(data[:-40]), ctx, cdf,
                                use_native=use_native)
    serial = rans.encode(syms, ctx, cdf)
    with pytest.raises(ValueError):
        rans.decode(serial[:2], 500, ctx, cdf, use_native=use_native)
    with pytest.raises(ValueError):      # a symbol outside the alphabet
        rans.encode(np.full(4, 16), np.zeros(4), cdf, use_native=use_native)


def test_bytes_from_words_and_decode_bytes_match_jax():
    rng = np.random.default_rng(4)
    lane_cdf = _tables(rng, 24, 30)
    t = 20
    syms = rng.integers(0, 29, (t, 24))
    ctx = np.broadcast_to(np.arange(24), (t, 24))
    data = rans.encode_interleaved(syms, ctx, lane_cdf, n_lanes=24)
    words = np.frombuffer(data, "<u2", offset=ilrans.unpack_header(data)[3])
    got = device_rans.bytes_from_words(words, words.size, syms.size, 24)
    assert got == data
    assert got == j_dev.bytes_from_words(words, words.size, syms.size, 24)
    out = device_rans.decode_bytes(data, lane_cdf, None, device="cpu")
    np.testing.assert_array_equal(out, syms.ravel())
    np.testing.assert_array_equal(
        out, j_dev.decode_bytes(data, jnp.asarray(lane_cdf), None))
    # a shared table with a row a symbol (kernel E's form), padded lanes
    table = _tables(rng, 7, 30)
    n = 500
    c = rng.integers(0, 7, n)
    s = rng.integers(0, 29, n)
    data = rans.encode_interleaved(s, c, table, n_lanes=32)
    out = device_rans.decode_bytes(data, table, c, device="cpu")
    np.testing.assert_array_equal(out, s)
    np.testing.assert_array_equal(out, j_dev.decode_bytes(data, table, c))
    bad = bytearray(data)
    bad[-3] ^= 0xFF
    with pytest.raises(ValueError, match="corrupt"):
        device_rans.decode_bytes(bytes(bad), table, c, device="cpu")


def test_serialized_tables_round_trip_and_match_jax():
    rng = np.random.default_rng(5)
    z = rng.integers(0, 128, size=(4, 4, 6)).astype(np.int8)
    z[..., 0] = 3                  # one symbol takes the whole row: 2^16 - 128
    cdfs = int_codec._histogram_cdfs(z)
    np.testing.assert_array_equal(cdfs, j_codec._histogram_cdfs(z[None]))
    data = int_codec._serialize_cdfs(cdfs)
    assert data == j_codec._serialize_cdfs(cdfs)
    assert len(data) == 2 * 6 * 129
    np.testing.assert_array_equal(int_codec._deserialize_cdfs(data, 6), cdfs)
    np.testing.assert_array_equal(j_codec._deserialize_cdfs(data, 6), cdfs)
    with pytest.raises(ValueError):
        int_codec._deserialize_cdfs(data[:-2], 6)


@pytest.fixture(scope="module")
def ref_net():
    params = j_io.load_checkpoint(os.path.join(CKPT,
                                               "reference_weights.npz"))
    net = codec_int.IntCodecNet(weights_io.params_from_jax(params),
                                device="cpu")
    x = np.random.default_rng(6).integers(0, 256, size=(2, 64, 64, 3),
                                          dtype=np.uint8)
    return params, net, x


def test_build_static_cdfs_matches_jax(ref_net):
    params, net, x = ref_net
    cfg = reference_net_for_input(64, 64)
    got = int_codec.build_static_cdfs(net, [x[:1], x[1:]])
    ref = j_codec.build_static_cdfs(
        params, [jnp.asarray(x[:1].view(np.int8)),
                 jnp.asarray(x[1:].view(np.int8))], cfg)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("coder", CODERS + ["device"])
def test_per_image_tables_match_jax(ref_net, coder):
    """Containers that embed their images' tables: byte-identical with the
    JAX package's on the same coder (the JAX package codes them on its
    host coder whatever the coder; the port's device coder on kernels B
    and C, here their plain versions), and each package decodes the
    other's, the port's on its device coder too."""
    params, net, x = ref_net
    cfg = reference_net_for_input(64, 64)
    xj = jnp.asarray(x.view(np.int8))
    ref = j_codec.compress_batch(params, xj, cfg, coder=coder)
    ours = int_codec.compress_batch(net, torch.from_numpy(x), coder=coder)
    assert ours == ref
    _, (_, tables, _) = container.unpack(ours[0])
    assert len(tables) == 2 * 192 * 129
    x_ref, z_ref = j_codec.decompress_batch(params, ours, coder=coder)
    for c in (coder, "device"):
        x_hat, z_hat = int_codec.decompress_batch(net, ref, coder=c)
        np.testing.assert_array_equal(z_hat.numpy(), np.asarray(z_ref))
        np.testing.assert_array_equal(x_hat.numpy(), np.asarray(x_ref))


def test_per_image_tables_run_once_an_image_on_the_device_coder(ref_net):
    """The device coder fits each image's tables from one bincount and
    runs the plain versions of kernels B and C once an image (B = 2), and
    its containers equal the native coder's; a batch that mixes containers
    with and without tables decodes on it with the static tables."""
    from simple_image_compression_network_tpu_torch.codec import cuda_rans
    _, net, x = ref_net
    x = torch.from_numpy(x)
    enc, dec = cuda_rans.encode_batch_compact, cuda_rans.decode
    runs = enc.plain_runs, dec.plain_runs
    blobs = int_codec.compress_batch(net, x, coder="device")
    x_hat, z_hat = int_codec.decompress_batch(net, blobs, coder="device")
    assert (enc.plain_runs - runs[0], dec.plain_runs - runs[1]) == (2, 2)
    assert blobs == int_codec.compress_batch(net, x, coder="native")
    z = net.analysis(x)
    assert torch.equal(z_hat, z)
    assert torch.equal(x_hat, net.synthesis(z))
    cdfs = int_codec._histogram_cdfs(z[1:].numpy())
    static = int_codec.compress_batch(net, x[1:], static_cdfs=cdfs)
    _, z_mix = int_codec.decompress_batch(net, [blobs[0], static[0]],
                                          static_cdfs=cdfs)
    assert torch.equal(z_mix, z)


@pytest.mark.parametrize("profile", list(wavelet_codec.PROFILES))
def test_haar_tables_device_coder_equals_native(profile):
    """The shipped Haar tables (rows with one symbol at 65,408): the device
    coder's plain version writes the native coder's containers on the
    profile's real latent, and each decodes the other's."""
    codec = wavelet_codec.WaveletCodec(profile, device="cpu")
    x = np.random.default_rng(7).integers(0, 256, size=(2, 64, 64, 3),
                                          dtype=np.uint8)
    wire = codec._wire_dev(x)
    z = codec.net.analysis(wire)
    dev = int_codec.compress_batch(codec.net, wire, static_cdfs=codec.cdfs)
    nat = int_codec.compress_batch(codec.net, wire, static_cdfs=codec.cdfs,
                                   coder="native")
    assert dev == nat
    for blobs, coder in ((dev, "native"), (nat, "device")):
        _, z_hat = int_codec.decompress_batch(codec.net, blobs,
                                              static_cdfs=codec.cdfs,
                                              coder=coder)
        assert torch.equal(z_hat, z)


@pytest.fixture(scope="module")
def hyper_codecs():
    path = os.path.join(CKPT, "hp_scale_l0.01.params.msgpack")
    variables = weights_io.load_hyper_checkpoint(path)
    port = hyperprior.ScaleHyperprior.from_checkpoint(path, device="cpu")
    return (j_hc.HyperCodec(j_hp.ScaleHyperprior(), variables),
            hyper_codec.HyperCodec(port))


def test_serial_hyper_tables_match_jax(hyper_codecs):
    j_codec_h, t_codec = hyper_codecs
    np.testing.assert_array_equal(t_codec.y_cdfs, j_codec_h.y_cdfs)


@pytest.mark.parametrize("seed", [8, 9])
def test_serial_hyper_format_matches_jax(hyper_codecs, seed):
    """Byte-identical with the JAX package's ``compress`` and decoded both
    ways, once the test has shown that both packages put every latent in
    the same scale bin."""
    j_codec_h, t_codec = hyper_codecs
    x = np.random.default_rng(seed).random((1, 64, 64, 3), np.float32)
    _, z_hat, j_sigma = j_codec_h._encode_parts(jnp.asarray(x))
    t_sigma = t_codec.model.scales_from_z(
        torch.from_numpy(np.asarray(z_hat, np.float32))).numpy()
    np.testing.assert_array_equal(
        entropy.scale_to_index(t_sigma.ravel(), t_codec.scale_table),
        j_ent.scale_to_index(j_sigma.ravel(), j_codec_h.scale_table))
    data = t_codec.compress(torch.from_numpy(x))
    assert data == j_codec_h.compress(jnp.asarray(x))
    x_hat, y_hat = t_codec.decompress(data)
    j_x, j_y = j_codec_h.decompress(data)
    np.testing.assert_array_equal(y_hat.numpy(), np.asarray(j_y))
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(j_x), atol=1e-4,
                               rtol=1e-4)
    y, _, _ = t_codec.encode_parts(torch.from_numpy(x))
    np.testing.assert_array_equal(y_hat.numpy(), y.numpy())
