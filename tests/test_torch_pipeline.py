"""The port's pipelined codecs on the CPU: the int8 pipelines against the
port's sync calls and the JAX package's pipelines (its scan engines, static
CDFs from its ``build_static_cdfs``), ``collect`` interleaved at depth 1,
poisoned width predictions, a corrupt container; the hyper pipelines against
the port's ``HyperCodec`` batch calls and the JAX package's hyper pipelines
at the small model of ``tests/test_hyper_dev.py`` (n = 8, m = 12,
128x128), poisoned predictions included."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from simple_image_compression_network_tpu.codec import hyper_codec as j_hc
from simple_image_compression_network_tpu.codec import int_codec as j_codec
from simple_image_compression_network_tpu.codec import pipeline as j_pipe
from simple_image_compression_network_tpu.config import reference_net_for_input
from simple_image_compression_network_tpu.models import hyperprior as j_hp
from simple_image_compression_network_tpu.utils import weights_io as j_io
from simple_image_compression_network_tpu_torch.codec import (
    container, hyper_codec, int_codec, pipeline)
from simple_image_compression_network_tpu_torch.models import (
    codec_int, hyperprior)
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "reference_weights.npz")


@pytest.fixture(scope="module")
def setup():
    """Three seeded 128x64 batches of two, the JAX parameters and CDFs,
    the port's net and its sync containers."""
    params = j_io.load_checkpoint(CKPT)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    cfg = reference_net_for_input(128, 64)
    rng = np.random.default_rng(5)
    xs = [rng.integers(0, 256, size=(2, 128, 64, 3), dtype=np.uint8)
          for _ in range(3)]
    xj = [jnp.asarray(x.view(np.int8)) for x in xs]
    cdfs = j_codec.build_static_cdfs(jp, [x[:1] for x in xj], cfg)
    net = codec_int.IntCodecNet(weights_io.params_from_jax(params),
                                device="cpu")
    sync = [int_codec.compress_batch(net, torch.from_numpy(x),
                                     static_cdfs=cdfs) for x in xs]
    return dict(jp=jp, cfg=cfg, xs=xs, xj=xj, cdfs=cdfs, net=net, sync=sync)


def test_pipelined_encoder_matches_sync_and_jax(setup):
    enc = pipeline.PipelinedEncoder(setup["net"], setup["cdfs"], depth=2)
    j_enc = j_pipe.PipelinedEncoder(setup["jp"], setup["cdfs"], setup["cfg"],
                                    depth=2)
    for x, xj in zip(setup["xs"], setup["xj"]):
        enc.submit(torch.from_numpy(x))
        j_enc.submit(xj)
    got, want = enc.drain(), j_enc.drain()
    assert len(got) == len(want) == 3
    assert got == setup["sync"]
    assert got == want
    assert enc._mxb == j_enc._mxb


def test_pipelined_decoder_matches_sync_and_jax(setup):
    net, cdfs = setup["net"], setup["cdfs"]
    dec = pipeline.PipelinedDecoder(net, cdfs, depth=2)
    for blobs in setup["sync"]:
        dec.submit(blobs)
    outs = dec.drain()
    assert len(outs) == 3
    for blobs, x_hat in zip(setup["sync"], outs):
        ref, _ = int_codec.decompress_batch(net, blobs, static_cdfs=cdfs)
        want, _ = j_codec.decompress_batch(setup["jp"], blobs,
                                           static_cdfs=cdfs, coder="device")
        assert torch.equal(x_hat, ref)
        np.testing.assert_array_equal(x_hat.numpy(), np.asarray(want))


def test_collect_interleaved(setup):
    enc = pipeline.PipelinedEncoder(setup["net"], setup["cdfs"], depth=1)
    assert enc.collect() is None
    enc.submit(torch.from_numpy(setup["xs"][0]))
    enc.submit(torch.from_numpy(setup["xs"][1]))   # depth 1: drains batch 0
    assert len(enc._q) == 1 and len(enc._out) == 1
    assert enc.collect() == setup["sync"][0]
    assert enc.collect() == setup["sync"][1]       # drains on demand
    assert enc.collect() is None and enc.drain() == []

    dec = pipeline.PipelinedDecoder(setup["net"], setup["cdfs"], depth=1)
    dec.submit(setup["sync"][0])
    dec.submit(setup["sync"][1])
    first = dec.collect()
    assert len(dec.drain()) == 1
    ref, _ = int_codec.decompress_batch(setup["net"], setup["sync"][0],
                                        static_cdfs=setup["cdfs"])
    assert torch.equal(first, ref)


@pytest.mark.parametrize("poison", [1, 4096, 1 << 30])
def test_poisoned_prediction(setup, poison):
    """A width prediction too narrow is fetched again, blocking; one too
    wide is cut to the buffer: the bytes stay the sync path's, and the JAX
    pipeline's under the same poison."""
    enc = pipeline.PipelinedEncoder(setup["net"], setup["cdfs"], depth=2)
    j_enc = j_pipe.PipelinedEncoder(setup["jp"], setup["cdfs"], setup["cfg"],
                                    depth=2)
    enc._mxb = j_enc._mxb = poison
    enc.submit(torch.from_numpy(setup["xs"][0]))
    j_enc.submit(setup["xj"][0])
    assert enc.drain() == j_enc.drain() == [setup["sync"][0]]
    enc._mxb = j_enc._mxb = poison
    for x, xj in zip(setup["xs"][1:], setup["xj"][1:]):
        enc.submit(torch.from_numpy(x))
        j_enc.submit(xj)
    assert enc.drain() == j_enc.drain() == setup["sync"][1:]


def test_pipelined_decoder_rejects_corrupt(setup):
    blobs = list(setup["sync"][0])
    bad = bytearray(blobs[-1])
    bad[-3] ^= 0xFF
    dec = pipeline.PipelinedDecoder(setup["net"], setup["cdfs"], depth=2)
    dec.submit(blobs[:-1] + [bytes(bad)])
    with pytest.raises(ValueError, match="corrupt"):
        dec.drain()
    with pytest.raises(ValueError, match="not an int8 codec container"):
        dec.submit([container.pack(container.CODEC_HYPERPRIOR_DEV,
                                   [b"", b"", b""])])
    with pytest.raises(ValueError, match="depth"):
        pipeline.PipelinedEncoder(setup["net"], setup["cdfs"], depth=0)


# ---------------------------------------------------------------------------
# hyper pipelines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hyper():
    """The n = 8, m = 12 model with seeded parameters, the port's codec and
    the JAX package's, three seeded 128x128 batches of two and the port's
    sync containers.

    The two packages quantize this untrained z density to tables up to 2
    apart (float32 sums in other orders; the trained checkpoint's tables
    agree, ``tests/test_torch_hyper.py``), so the JAX codec takes the
    port's z table: the integers y, z and the scale bins agree at these
    inputs, which the tests assert, and the containers compare byte for
    byte."""
    model = j_hp.ScaleHyperprior(n=8, m=12)
    rng = np.random.default_rng(0)
    xs = [rng.random((2, 128, 128, 3), np.float32) for _ in range(3)]
    variables = jax.tree_util.tree_map(np.asarray, unfreeze(model.init(
        jax.random.PRNGKey(0), jnp.asarray(xs[0][:1]))))
    port = hyperprior.ScaleHyperprior(n=8, m=12, device="cpu")
    port.load_state_dict(weights_io.hyper_params_from_jax(variables))
    codec = hyper_codec.HyperCodec(port)
    j_codec = j_hc.HyperCodec(model, variables)
    j_codec.z_cdfs = codec.z_cdfs
    xt = [torch.from_numpy(x) for x in xs]
    sync = [codec.compress_batch(x) for x in xt]
    return dict(codec=codec, j_codec=j_codec, xs=xt, sync=sync)


def test_hyper_integers_agree_with_jax(hyper):
    """The precondition of the byte comparisons: both packages' integer
    latents and scale bins agree on every batch."""
    codec, j_codec = hyper["codec"], hyper["j_codec"]
    for x in hyper["xs"]:
        y, z, sigma = codec.encode_parts(x)
        j_y, j_z, _, j_sigma = j_codec._encode_dev_arrays(jnp.asarray(x))
        np.testing.assert_array_equal(y.numpy(), np.asarray(j_y))
        np.testing.assert_array_equal(z.numpy(), np.asarray(j_z))
        np.testing.assert_array_equal(codec._scale_ctx(sigma).numpy(),
                                      np.asarray(j_codec._scale_ctx(j_sigma)))


def test_hyper_pipelined_encoder_matches_batch(hyper):
    enc = pipeline.HyperPipelinedEncoder(hyper["codec"], depth=2)
    j_enc = j_pipe.HyperPipelinedEncoder(hyper["j_codec"], depth=2)
    for x in hyper["xs"]:
        enc.submit(x)
        j_enc.submit(jnp.asarray(x.numpy()))
    got = enc.drain()
    assert got == hyper["sync"]
    assert got == j_enc.drain()
    assert (hyper["codec"]._mxb_z, hyper["codec"]._mxb_y) == (
        hyper["j_codec"]._mxb_z, hyper["j_codec"]._mxb_y)
    enc = pipeline.HyperPipelinedEncoder(hyper["codec"], depth=1)
    enc.submit(hyper["xs"][0])
    enc.submit(hyper["xs"][1])
    assert enc.collect() == hyper["sync"][0]
    assert enc.drain() == hyper["sync"][1:2]


def test_hyper_pipelined_decoder_matches_batch(hyper):
    """y_hat exact against the port's batch calls and the JAX pipeline;
    x_hat exact against the port's, and against JAX's to float32 (the two
    frameworks sum the synthesis convolutions in other orders)."""
    codec = hyper["codec"]
    dec = pipeline.HyperPipelinedDecoder(codec, depth=2)
    j_dec = j_pipe.HyperPipelinedDecoder(hyper["j_codec"], depth=2)
    for blobs in hyper["sync"]:
        dec.submit(blobs)
        j_dec.submit(blobs)
    outs, j_outs = dec.drain(), j_dec.drain()
    assert len(outs) == len(j_outs) == 3
    for blobs, (x_hat, y_hat), (j_x, j_y) in zip(hyper["sync"], outs,
                                                  j_outs):
        ref_x, ref_y = codec.decompress_batch(blobs)
        assert torch.equal(x_hat, ref_x) and torch.equal(y_hat, ref_y)
        np.testing.assert_array_equal(y_hat.numpy(), np.asarray(j_y))
        np.testing.assert_allclose(x_hat.numpy(), np.asarray(j_x),
                                   atol=1e-4, rtol=1e-4)
    y, _, _ = codec.encode_parts(hyper["xs"][2])
    assert torch.equal(outs[2][1], y.to(torch.float32))


@pytest.mark.parametrize("poison", [1, 1 << 30])
def test_hyper_poisoned_prediction(hyper, poison):
    """Poisoned z and y width predictions in both packages: the batch calls
    and the pipelines still give the sync bytes, the JAX pipeline's too."""
    codec, j_codec = hyper["codec"], hyper["j_codec"]
    for c in (codec, j_codec):
        c._mxb_z = c._mxb_y = poison
    assert codec.compress_batch(hyper["xs"][0]) == hyper["sync"][0]
    enc = pipeline.HyperPipelinedEncoder(codec, depth=2)
    j_enc = j_pipe.HyperPipelinedEncoder(j_codec, depth=2)
    for c in (codec, j_codec):
        c._mxb_z = c._mxb_y = poison
    enc.submit(hyper["xs"][1])
    j_enc.submit(jnp.asarray(hyper["xs"][1].numpy()))
    for c in (codec, j_codec):
        c._mxb_z = c._mxb_y = poison    # the second submit's too
    enc.submit(hyper["xs"][2])
    j_enc.submit(jnp.asarray(hyper["xs"][2].numpy()))
    assert enc.drain() == hyper["sync"][1:]
    assert j_enc.drain() == hyper["sync"][1:]
