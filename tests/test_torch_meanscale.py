"""The port's mean-scale hyperprior (``MeanScaleHyperprior``,
``MeanScaleCodec``) against the JAX package's: the float modules (float32,
atol = rtol = 1e-4, as ``tests/test_torch_hyper.py`` holds the scale
model), the centred symbols round(y - mu), the z tables of the trained
checkpoint, the device-format and serial-format containers (byte-identical,
cross-decoding both ways), the checkpoint guard and the pipelines.

A symbol whose y - mu lies within 1e-4 of a half-integer is decided by an
ulp of mu, which two frameworks need not share: such ties are exempt from
the symbol comparison and counted, and the count is asserted (at these
seeds 0 of 12,288 positions of the seeded model, 1 of 6,144 of the trained
one: about one in 5,000 positions is expected to lie so close; mu differs
by at most 3e-6 between the frameworks there, so the tie, 9e-5 from the
half, does not flip)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from simple_image_compression_network_tpu.codec import hyper_codec as j_hc
from simple_image_compression_network_tpu.models import hyperprior as j_hp
from simple_image_compression_network_tpu_torch.codec import (
    container, hyper_codec, pipeline)
from simple_image_compression_network_tpu_torch.models import hyperprior
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "hp_meanscale_l0.01.params.msgpack")
SCALE_CKPT = os.path.join(ROOT, "checkpoints",
                          "hp_scale_l0.01.params.msgpack")
TOL = dict(atol=1e-4, rtol=1e-4)
TIE = 1e-4


@pytest.fixture(scope="module")
def trained():
    """The trained checkpoint: (JAX codec, port codec), images 2 x 64x64."""
    variables = weights_io.load_hyper_checkpoint(CKPT)
    j_codec = j_hc.MeanScaleCodec(j_hp.MeanScaleHyperprior(), variables)
    codec = hyper_codec.MeanScaleCodec.from_checkpoint(CKPT, device="cpu")
    x = np.random.default_rng(31).random((2, 64, 64, 3), np.float32)
    return j_codec, codec, x


@pytest.fixture(scope="module")
def seeded():
    """Seeded n = 16, m = 24 parameters: (JAX codec, port codec), images
    2 x 128x128.  The two builds' z tables of an untrained density may
    differ (ROADMAP queue 3); at this seed they are equal (asserted below),
    so each codec keeps its own table."""
    model = j_hp.MeanScaleHyperprior(n=16, m=24)
    variables = jax.tree_util.tree_map(np.asarray, unfreeze(jax.jit(
        model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)))))
    port = hyperprior.MeanScaleHyperprior(n=16, m=24, device="cpu")
    port.load_state_dict(weights_io.hyper_params_from_jax(variables))
    codec = hyper_codec.MeanScaleCodec(port)
    j_codec = j_hc.MeanScaleCodec(model, variables)
    x = np.random.default_rng(32).random((2, 128, 128, 3), np.float32)
    return j_codec, codec, x


def _ties(d: np.ndarray) -> np.ndarray:
    return np.abs(np.abs(d - np.round(d)) - 0.5) < TIE


def _parts(case):
    """Both packages' (symbols, z_hat, mu, sigma) of the case's images."""
    j_codec, codec, x = case
    j = [np.asarray(a) for a in j_codec._encode_dev_arrays(jnp.asarray(x))]
    t = [a.numpy() for a in codec.encode_arrays(torch.from_numpy(x))]
    return j, t


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_model_matches_jax(request, which):
    """y, z_hat, mu and sigma, and g_s of the decoded latent (the JAX
    codec's jitted programs of ``analysis_arrays``, ``params_from_z`` and
    ``decode_arrays``)."""
    j_codec, codec, x = request.getfixturevalue(which)
    y, z = j_codec._analysis_arrays(jnp.asarray(x))
    ty, tz = codec.model.analysis_arrays(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    mu, sigma = j_codec._params_from_z(z)
    tmu, tsigma = codec.model.params_from_z(torch.from_numpy(np.array(z)))
    assert tmu.shape == tsigma.shape == ty.shape
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(tsigma.numpy(), np.asarray(sigma), **TOL)
    y_hat = np.round(np.asarray(y) - np.asarray(mu)) + np.asarray(mu)
    np.testing.assert_allclose(
        codec.model.decode_arrays(torch.from_numpy(y_hat)).numpy(),
        np.asarray(j_codec._decode_arrays(jnp.asarray(y_hat))), **TOL)


@pytest.mark.parametrize("which,n_ties", [("seeded", 0), ("trained", 1)])
def test_symbols_match_jax(request, which, n_ties):
    """round(y - mu) equal to the JAX package's off the ties (counted),
    z_hat equal, and the scale bins equal: the precondition of the byte
    comparisons below."""
    case = request.getfixturevalue(which)
    (j_sym, j_z, j_mu, j_sig), (sym, z, mu, sig) = _parts(case)
    _, codec, x = case
    y, _ = codec.model.analysis_arrays(torch.from_numpy(x))
    ties = _ties(y.numpy() - mu) | _ties(y.numpy() - j_mu)
    assert int(ties.sum()) == n_ties
    np.testing.assert_array_equal(sym[~ties], j_sym[~ties].astype(np.int32))
    np.testing.assert_array_equal(z, j_z.astype(np.int32))
    np.testing.assert_array_equal(
        codec._scale_ctx(torch.from_numpy(sig)).numpy(),
        np.asarray(case[0]._scale_ctx(jnp.asarray(j_sig))))


@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_z_tables_match_jax(request, which):
    """The factorized z tables, integer for integer: of hp_meanscale_l0.01
    and of the seeded model (ROADMAP queue 3: with other parameters the two
    builds' float32 sums may move a rounding)."""
    j_codec, codec, _ = request.getfixturevalue(which)
    assert codec.z_cdfs.shape == (codec.model.n, 129)
    np.testing.assert_array_equal(codec.z_cdfs, j_codec.z_cdfs)


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_device_containers_byte_identical_and_cross_decode(request, which):
    j_codec, codec, x = request.getfixturevalue(which)
    blobs = codec.compress_batch(torch.from_numpy(x))
    j_blobs = j_codec.compress_batch(jnp.asarray(x))
    assert blobs == j_blobs
    assert {container.unpack(b)[0] for b in blobs} == {
        container.CODEC_HYPERPRIOR_DEV}
    x_hat, y_hat, z_hat = codec.decompress_batch(j_blobs, return_z=True)
    j_x, j_y = j_codec.decompress_batch(blobs)
    sym, z, mu, _ = codec.encode_arrays(torch.from_numpy(x))
    assert torch.equal(y_hat, sym.to(torch.float32) + mu)
    assert torch.equal(z_hat, z.to(torch.float32))
    np.testing.assert_allclose(y_hat.numpy(), np.asarray(j_y), **TOL)
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(j_x), **TOL)


def test_serial_containers_byte_identical_and_cross_decode(trained):
    j_codec, codec, x = trained
    x1 = x[:1]
    data = codec.compress(torch.from_numpy(x1))
    assert data == j_codec.compress(jnp.asarray(x1))
    assert container.unpack(data)[0] == container.CODEC_HYPERPRIOR
    x_hat, y_hat = codec.decompress(data)
    j_x, j_y = j_codec.decompress(data)
    sym, _, mu, _ = codec.encode_arrays(torch.from_numpy(x1))
    assert torch.equal(y_hat, sym.to(torch.float32) + mu)
    np.testing.assert_allclose(y_hat.numpy(), np.asarray(j_y), **TOL)
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(j_x), **TOL)
    # the serial and the device format carry the same symbols
    _, y_dev = codec.decompress_batch(codec.compress_batch(
        torch.from_numpy(x1)))
    assert torch.equal(y_hat, y_dev)


def test_roundtrip_exact_and_corrupt_rejected(seeded):
    _, codec, x = seeded
    xt = torch.from_numpy(x)
    blobs = codec.compress_batch(xt)
    x_hat, y_hat = codec.decompress_batch(blobs)
    sym, _, mu, _ = codec.encode_arrays(xt)
    assert torch.equal(y_hat, sym.to(torch.float32) + mu)
    assert torch.equal(x_hat, codec.model.decode_arrays(y_hat))
    _, sections = container.unpack(blobs[-1])
    y_end = len(blobs[-1]) - len(sections[3]) - len(sections[4])
    bad = bytearray(blobs[-1])
    bad[y_end - len(sections[2]) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="corrupt"):
        codec.decompress_batch(blobs[:-1] + [bytes(bad)])


@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_decode_alone_and_in_any_batch_equals_the_batch_decode(request,
                                                               which):
    """Containers of a B = 2 batch decoded alone (B = 1) and four at once
    (B = 4) give the B = 2 decode's y_hat value for value: the codec runs
    h_s image by image, so mu and sigma of an image do not depend on its
    batch (with h_s batched, mu moved by ulps between B = 1 and B = 2 on
    the CPU, and on the card sigmas crossed scale-bin edges)."""
    _, codec, x = request.getfixturevalue(which)
    xs = [torch.from_numpy(x), torch.from_numpy(x[::-1].copy())]
    blobs = [codec.compress_batch(b) for b in xs]
    y_ref = [codec.decompress_batch(bl)[1] for bl in blobs]
    for bl, ref in zip(blobs, y_ref):
        for i, blob in enumerate(bl):
            assert torch.equal(codec.decompress_batch([blob])[1][0], ref[i])
    y_all = codec.decompress_batch(blobs[0] + blobs[1])[1]
    assert torch.equal(y_all, torch.cat(y_ref))


def test_pipelines_take_the_meanscale_codec(seeded):
    """The hyper pipelines over ``MeanScaleCodec``'s schedule and drain
    phases give the batch calls' containers and reconstructions."""
    _, codec, x = seeded
    xs = [torch.from_numpy(x), torch.from_numpy(x[::-1].copy())]
    sync = [codec.compress_batch(b) for b in xs]
    enc = pipeline.HyperPipelinedEncoder(codec, depth=2)
    dec = pipeline.HyperPipelinedDecoder(codec, depth=2)
    for b in xs:
        enc.submit(b)
    assert enc.drain() == sync
    for blobs in sync:
        dec.submit(blobs)
    for blobs, (x_hat, y_hat) in zip(sync, dec.drain()):
        ref_x, ref_y = codec.decompress_batch(blobs)
        assert torch.equal(x_hat, ref_x) and torch.equal(y_hat, ref_y)


# ---------------------------------------------------------------------------
# Checkpoint guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,path", [
    (hyperprior.MeanScaleHyperprior, SCALE_CKPT),
    (hyperprior.ScaleHyperprior, CKPT),
    (hyper_codec.MeanScaleCodec, SCALE_CKPT),
    (hyper_codec.HyperCodec, CKPT)],
    ids=["meanscale-model", "scale-model", "meanscale-codec", "scale-codec"])
def test_from_checkpoint_refuses_the_other_family(cls, path):
    """The container and checkpoint formats carry no model id: the guard
    is h_s's last conv, M outputs (scale) or 2M (mean-scale)."""
    with pytest.raises(ValueError, match="checkpoint"):
        cls.from_checkpoint(path, device="cpu")
