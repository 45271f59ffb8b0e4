"""The bf16 serving path of the port's hyperpriors against the JAX
package's ``dtype=jnp.bfloat16`` models.

Both packages round every conv's output to bf16 and add its bias in bf16,
and keep GDN's channel mix in float32.  One layer alone agrees (a rounding
in one output of 10^4 apart), but the two frameworks sum the float32
accumulations in other orders, and over four layers one-ulp differences
spread: at these sizes the port's bf16 y lies within 0.09 of the JAX
package's bf16 y (|y| up to 11), about as far as the JAX bf16 y lies from
its float32 y (0.046), and x_hat within 0.005.  The tolerances below are
about twice that, measured on the CPU.

The bf16 codec is consistent with itself: both ends run the bf16 programs,
so its round trip is exact (as ``tests/test_bf16_path.py`` holds the JAX
package's); it is not meant to cross-decode with the float32 codec."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from simple_image_compression_network_tpu.models import hyperprior as j_hp
from simple_image_compression_network_tpu.ops.gdn import GDN as JGDN
from simple_image_compression_network_tpu_torch.codec import (
    container, hyper_codec)
from simple_image_compression_network_tpu_torch.models import hyperprior
from simple_image_compression_network_tpu_torch.ops.gdn import GDN, reparam
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
BF16 = torch.bfloat16
ULP = 2.0 ** -8          # bf16's relative spacing
Y_TOL = dict(atol=2.0 ** -4, rtol=2.0 ** -5)    # y, mu, sigma
X_TOL = dict(atol=2.0 ** -7, rtol=0.0)          # x_hat in [0, 1]

FAMILIES = {
    "scale": (j_hp.ScaleHyperprior, hyperprior.ScaleHyperprior,
              hyper_codec.HyperCodec, "hp_scale_l0.01.params.msgpack"),
    "meanscale": (j_hp.MeanScaleHyperprior, hyperprior.MeanScaleHyperprior,
                  hyper_codec.MeanScaleCodec,
                  "hp_meanscale_l0.01.params.msgpack"),
}


def _case(family: str, which: str):
    """(JAX bf16 model, flax variables, port bf16 model, port float32
    model, images): seeded n = 16, m = 24 at 2 x 128x128, or the trained
    checkpoint at 1 x 64x64."""
    j_cls, cls, _, ckpt = FAMILIES[family]
    if which == "seeded":
        model = j_cls(n=16, m=24)
        variables = jax.tree_util.tree_map(np.asarray, unfreeze(jax.jit(
            model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))))
        state = weights_io.hyper_params_from_jax(variables)
        ports = []
        for dtype in (BF16, torch.float32):
            ports.append(cls(n=16, m=24, device="cpu", dtype=dtype))
            ports[-1].load_state_dict(state)
        shape = (2, 128, 128, 3)
    else:
        path = os.path.join(CKPTS, ckpt)
        model, variables = j_cls(), weights_io.load_hyper_checkpoint(path)
        ports = [cls.from_checkpoint(path, device="cpu", dtype=d)
                 for d in (BF16, torch.float32)]
        shape = (1, 64, 64, 3)
    x = np.random.default_rng(0).uniform(0.1, 0.9, size=shape).astype(
        np.float32)
    return model.clone(dtype=jnp.bfloat16), variables, ports[0], ports[1], x


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# GDN
# ---------------------------------------------------------------------------

def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF16).float().numpy()


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_bf16_mix_stays_float32(inverse):
    """On a bf16 input the mix is a float32 sum of bf16-rounded x^2 and
    gamma, never rounded to bf16: the port's GDN equals that (numpy,
    float64 sums) and the JAX package's GDN(dtype=bf16) within one bf16
    ulp, while a mix rounded to bf16 lands further off."""
    c = 32
    rng = np.random.default_rng(4)
    x = _bf16(rng.normal(size=(2, 6, 6, c)))
    params = {"beta": rng.uniform(0.5, 1.5, size=c).astype(np.float32),
              "gamma": rng.uniform(0.0, 0.3, size=(c, c)).astype(np.float32)}
    mod = GDN(c, inverse=inverse)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got = mod(_nchw(x).to(BF16))
    assert got.dtype == BF16
    got = got.float().numpy().transpose(0, 2, 3, 1)

    beta = reparam(mod.beta.detach(), mod.beta_min).numpy()
    gamma = _bf16(reparam(mod.gamma.detach()).numpy()).astype(np.float64)
    mix = (_bf16(np.square(x)).astype(np.float64) @ gamma).astype(np.float32)
    for m, near in ((mix, True), (_bf16(mix), False)):
        norm = np.sqrt(beta + m)
        ref = _bf16(x * norm if inverse else x / norm)
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
        assert (err.max() <= ULP) == near, err.max()

    j_gdn = JGDN(inverse=inverse, dtype=jnp.bfloat16)
    want = np.asarray(j_gdn.apply({"params": params}, jnp.asarray(
        x, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["seeded", "trained"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_model_matches_jax_bf16(family, which):
    """y, z_hat, the prior (mu, sigma) of the same z_hat and x_hat of the
    same y_hat, against the JAX package's bf16 model, within the stated
    tolerances; z_hat equal."""
    fast, variables, port, _, x = _case(family, which)
    y, z = jax.jit(lambda a: fast.apply(
        variables, a, method=fast.analysis_arrays))(jnp.asarray(x))
    ty, tz = port.analysis_arrays(torch.from_numpy(x))
    assert ty.dtype == tz.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **Y_TOL)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    zt = torch.from_numpy(np.array(z))
    if family == "meanscale":
        mu, sigma = jax.jit(lambda a: fast.apply(
            variables, a, method=fast.params_from_z))(z)
        tmu, tsigma = port.params_from_z(zt)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), **Y_TOL)
    else:
        sigma = jax.jit(lambda a: fast.apply(
            variables, a, method=fast.scales_from_z))(z)
        tsigma = port.scales_from_z(zt)
    assert tsigma.dtype == torch.float32
    np.testing.assert_allclose(tsigma.numpy(), np.asarray(sigma),
                               rtol=Y_TOL["rtol"], atol=0)
    y_hat = np.round(np.asarray(y))
    x_hat = jax.jit(lambda a: fast.apply(
        variables, a, method=fast.decode_arrays))(jnp.asarray(y_hat))
    tx = port.decode_arrays(torch.from_numpy(y_hat))
    assert tx.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), np.asarray(x_hat), **X_TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_codec_roundtrip_exact(family):
    """Device format (B = 2) and serial format (one image): the decoded
    latents equal the encoder's symbols (plus mu), z_hat equal, x_hat
    float32."""
    _, _, port, _, x = _case(family, "seeded")
    codec = FAMILIES[family][2](port)
    xt = torch.from_numpy(x)
    sym, z, mu, _ = codec.encode_arrays(xt)
    expect = sym.to(torch.float32) + (0 if mu is None else mu)
    blobs = codec.compress_batch(xt)
    x_hat, y_hat, z_hat = codec.decompress_batch(blobs, return_z=True)
    assert torch.equal(y_hat, expect)
    assert torch.equal(z_hat, z.to(torch.float32))
    assert x_hat.dtype == torch.float32 and x_hat.shape == xt.shape
    data = codec.compress(xt[:1])
    assert container.unpack(data)[0] == container.CODEC_HYPERPRIOR
    x1, y1 = codec.decompress(data)
    assert torch.equal(y1, expect[:1])
    assert torch.equal(x1, x_hat[:1])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_shares_the_float32_checkpoint(family):
    """One checkpoint drives both dtypes: the bf16 model's parameters are
    the float32 model's, in float32; its outputs are float32 and close to
    the float32 model's; other dtypes are refused."""
    _, _, port, port32, x = _case(family, "trained")
    s16, s32 = port.state_dict(), port32.state_dict()
    assert list(s16) == list(s32)
    for k in s32:
        assert s16[k].dtype == torch.float32 and torch.equal(s16[k], s32[k])
    y16, _ = port.analysis_arrays(torch.from_numpy(x))
    y32, _ = port32.analysis_arrays(torch.from_numpy(x))
    assert not torch.equal(y16, y32)
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), **Y_TOL)
    with pytest.raises(ValueError, match="dtype"):
        FAMILIES[family][1](n=4, m=6, device="cpu", dtype=torch.float16)
