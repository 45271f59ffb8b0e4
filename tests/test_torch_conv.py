"""The port's int8 conv forms (simple_image_compression_network_tpu_torch.ops)
against the JAX package: weight rewrites, layouts, the 3x3 kernel contract
(Pallas flat kernel in interpret mode) and the direct 5x5 forms.  Exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_image_compression_network_tpu.ops import conv_fast as j_fast
from simple_image_compression_network_tpu.ops import conv_int as j_int
from simple_image_compression_network_tpu.ops import pallas_conv
from simple_image_compression_network_tpu_torch.ops import conv_fast as t_fast
from simple_image_compression_network_tpu_torch.ops import conv_int as t_int
from simple_image_compression_network_tpu_torch.ops import cuda_conv

torch.set_num_threads(1)


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, size=shape, dtype=np.int8)


@pytest.mark.parametrize("name", ["conv_weights_s2d", "deconv_weights_d2s",
                                  "deconv_weights_s2dtail"])
def test_weight_rewrites_match_jax(rng, name):
    w = _int8(rng, (6, 5, 5, 4), -8, 8)
    got = getattr(t_fast, name)(w).numpy()
    ref = np.asarray(getattr(j_fast, name)(jnp.asarray(w)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,shape", [("space_to_depth", (2, 8, 6, 5)),
                                        ("depth_to_space", (2, 4, 3, 20)),
                                        ("depth_to_space4", (2, 3, 2, 32))])
def test_layouts_match_jax(rng, name, shape):
    x = _int8(rng, shape)
    got = getattr(t_fast, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(getattr(j_fast, name)(jnp.asarray(x))))


def test_to_wire_int8_is_a_bitcast(rng):
    x = rng.integers(0, 256, size=(3, 7), dtype=np.uint8)
    got = t_int.to_wire_int8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x.view(np.int8))
    np.testing.assert_array_equal(
        got, np.asarray(j_int.to_wire_int8(jnp.asarray(x))))


@pytest.mark.parametrize("c,n,relu", [(12, 16, True), (24, 48, True),
                                      (8, 20, False)])
def test_conv3x3_matches_pallas_flat(rng, c, n, relu):
    """The 3x3/s1/SAME contract of kernel A: the port's plain version (what
    the wrapper runs for CPU tensors) == the TPU kernel in interpret mode."""
    x = _int8(rng, (2, 16, 12, c))
    w3 = _int8(rng, (3, 3, c, n), -8, 8)
    b = _int8(rng, (n,))
    runs = cuda_conv.conv3x3_s1_int8.plain_runs
    launches = cuda_conv.conv3x3_s1_int8.launches
    got = cuda_conv.conv3x3_s1_int8(torch.from_numpy(x), torch.from_numpy(w3),
                                    torch.from_numpy(b), relu=relu)
    assert cuda_conv.conv3x3_s1_int8.plain_runs == runs + 1
    assert cuda_conv.conv3x3_s1_int8.launches == launches
    ref = pallas_conv.conv3x3_s1_int8_flat(
        jnp.asarray(x), jnp.asarray(w3), jnp.asarray(b), relu=relu,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_conv3x3_wrapper_rejects_bad_input(rng):
    x = torch.from_numpy(_int8(rng, (1, 4, 4, 8)))
    w3 = torch.from_numpy(_int8(rng, (3, 3, 8, 4)))
    b = torch.from_numpy(_int8(rng, (4,)))
    with pytest.raises(ValueError):
        cuda_conv.conv3x3_s1_int8(x, w3[:, :, :4], b)
    with pytest.raises(TypeError):
        cuda_conv.conv3x3_s1_int8(x.to(torch.int32), w3, b)
    with pytest.raises(ValueError):
        cuda_conv.conv3x3_s1_int8(x.to("meta"), w3.to("meta"), b.to("meta"))


@pytest.mark.parametrize("layer", ["s2d", "d2s", "tailfused"])
def test_layers_match_jax_direct_forms(rng, layer):
    """s2d / d2s / tail-fused layers (kernel A's rewrites) == the JAX
    package's direct 5x5 forms, and the port's own goldens agree."""
    if layer == "s2d":
        x = rng.integers(0, 256, size=(2, 12, 8, 3), dtype=np.uint8)
        w = _int8(rng, (8, 5, 5, 3), -8, 8)
        b = _int8(rng, (8,))
        xj = jnp.asarray(x.view(np.int8))
        ref = np.asarray(j_int.conv2d_int8(xj, jnp.asarray(w), jnp.asarray(b)))
        xt = t_int.to_wire_int8(torch.from_numpy(x))
        got = t_fast.conv2d_int8_s2d(xt, w, b)
        gold = t_int.conv2d_int8(xt, torch.from_numpy(w), torch.from_numpy(b))
    elif layer == "d2s":
        x = _int8(rng, (2, 5, 4, 6), 0, 128)
        w = _int8(rng, (7, 5, 5, 6), -8, 8)
        b = _int8(rng, (7,))
        ref = np.asarray(j_int.deconv2d_int8(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b)))
        xt = torch.from_numpy(x)
        got = t_fast.deconv2d_int8_d2s(xt, w, b)
        gold = t_int.deconv2d_int8(xt, torch.from_numpy(w),
                                   torch.from_numpy(b))
    else:
        x = _int8(rng, (2, 3, 4, 6), 0, 128)
        w_a, b_a = _int8(rng, (8, 5, 5, 6), -8, 8), _int8(rng, (8,))
        w_b, b_b = _int8(rng, (3, 5, 5, 8), -8, 8), _int8(rng, (3,))
        h = j_int.deconv2d_int8(jnp.asarray(x), jnp.asarray(w_a),
                                jnp.asarray(b_a))
        ref = np.asarray(j_int.deconv2d_int8(h, jnp.asarray(w_b),
                                             jnp.asarray(b_b)))
        xt = torch.from_numpy(x)
        got = t_fast.deconv2d_int8_tail_fused(xt, w_a, b_a, w_b, b_b)
        gold = t_int.deconv2d_int8(
            t_int.deconv2d_int8(xt, torch.from_numpy(w_a),
                                torch.from_numpy(b_a)),
            torch.from_numpy(w_b), torch.from_numpy(b_b))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(gold.numpy(), ref)
