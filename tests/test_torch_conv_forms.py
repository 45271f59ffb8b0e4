"""The port's remaining int8 op forms (``laxf32``, ``dilated``, ``phased``,
``s4d``, ``gemm``, ``tapn`` and their ``_acc`` forms) and the whole net
under the plans that use them, against the JAX package on the CPU.  The
forms on kernels A and F run their plain versions here (CPU tensors);
every comparison is exact (integers, tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_image_compression_network_tpu.config import (
    reference_net_for_input as j_geometry)
from simple_image_compression_network_tpu.models import codec_int as j_net
from simple_image_compression_network_tpu.ops import conv_fast as j_fast
from simple_image_compression_network_tpu.ops import conv_int as j_int
from simple_image_compression_network_tpu_torch.config import (
    reference_net_for_input)
from simple_image_compression_network_tpu_torch.models import codec_int
from simple_image_compression_network_tpu_torch.ops import (conv_fast,
                                                            conv_int,
                                                            cuda_conv)

torch.set_num_threads(1)

PLANS = {"s4d_phased": ("s4d",) * 4 + ("phased",) * 4,
         "gemm_tapn": ("gemm",) * 4 + ("tapn",) * 4,
         "laxf32": ("laxf32", "lax", "lax", "lax") + ("dilated",) * 4}


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, size=shape, dtype=np.int8)


def _layer(rng, shape, o, lo=-128):
    return (_int8(rng, shape, lo), _int8(rng, (o, 5, 5, shape[3]), -8, 8),
            _int8(rng, (o,)))


def _same(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _runs(counter, fn):
    """fn()'s result and how many plain runs of the kernel it made."""
    before = counter.plain_runs
    out = fn()
    return out, counter.plain_runs - before


# (port function, JAX function, input shape, out channels, kernel counter,
# plain runs expected); the RGB shapes (3 in or out) are the net's ends
CONV_FORMS = {
    "conv2d_int8_s4d L0": (conv_fast.conv2d_int8_s4d, j_fast.conv2d_int8_s4d,
                           (2, 16, 12, 3), 16,
                           cuda_conv.conv3x3_s1_int8, 1),
    "conv2d_int8_s4d": (conv_fast.conv2d_int8_s4d, j_fast.conv2d_int8_s4d,
                        (1, 8, 16, 24), 20, cuda_conv.conv3x3_s1_int8, 1),
    "conv2d_int8_gemm L0": (conv_fast.conv2d_int8_gemm,
                            j_fast.conv2d_int8_gemm, (2, 16, 12, 3), 16,
                            cuda_conv.conv_sparse_int8, 1),
    "conv2d_int8_gemm": (conv_fast.conv2d_int8_gemm, j_fast.conv2d_int8_gemm,
                         (1, 8, 10, 32), 24, cuda_conv.conv_sparse_int8, 1),
    "conv2d_int8_f32 L0": (conv_int.conv2d_int8_f32, j_int.conv2d_int8_f32,
                           (2, 16, 12, 3), 16, None, 0),
    "deconv2d_int8_phased": (conv_int.deconv2d_int8_phased,
                             j_int.deconv2d_int8_phased, (1, 6, 5, 24), 16,
                             cuda_conv.conv_sparse_int8, 4),
    "deconv2d_int8_phased L7": (conv_int.deconv2d_int8_phased,
                                j_int.deconv2d_int8_phased, (2, 8, 6, 16), 3,
                                cuda_conv.conv_sparse_int8, 4),
    "deconv2d_int8_tapn": (conv_fast.deconv2d_int8_tapn,
                           j_fast.deconv2d_int8_tapn, (1, 6, 5, 24), 16,
                           cuda_conv.conv_sparse_int8, 1),
    "deconv2d_int8_tapn L7": (conv_fast.deconv2d_int8_tapn,
                              j_fast.deconv2d_int8_tapn, (2, 8, 6, 16), 3,
                              cuda_conv.conv_sparse_int8, 1),
}


@pytest.mark.parametrize("name", list(CONV_FORMS))
def test_layer_form_matches_jax(rng, name):
    """Each layer form == its JAX counterpart; the forms on kernels A and F
    reach them through their wrappers (``plain_runs`` counts them)."""
    fn, jfn, shape, o, counter, runs = CONV_FORMS[name]
    x, w, b = _layer(rng, shape, o, lo=0 if "deconv" in name else -128)
    if counter is None:
        got = fn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    else:
        got, n = _runs(counter, lambda: fn(torch.from_numpy(x),
                                           torch.from_numpy(w),
                                           torch.from_numpy(b)))
        assert n == runs
    _same(got, jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("form", ["gemm_acc", "acc_phased"])
def test_acc_forms_match_jax(rng, form):
    """The exact accumulators (plain on every device) == JAX's int32."""
    if form == "gemm_acc":
        x, w, _ = _layer(rng, (2, 12, 8, 5), 7)
        got = conv_fast.conv2d_int8_gemm_acc(torch.from_numpy(x),
                                             torch.from_numpy(w))
        ref = j_fast.conv2d_int8_gemm_acc(jnp.asarray(x), jnp.asarray(w))
    else:
        x, w, _ = _layer(rng, (2, 5, 7, 6), 4)
        got = conv_int.deconv2d_int8_acc_phased(torch.from_numpy(x),
                                                torch.from_numpy(w))
        ref = j_int.deconv2d_int8_acc_phased(jnp.asarray(x), jnp.asarray(w))
        _same(got, conv_int.deconv2d_int8_acc(torch.from_numpy(x),
                                              torch.from_numpy(w)).numpy())
    assert got.dtype == torch.int64
    _same(got, ref)


@pytest.mark.parametrize("kw", [{}, {"dilation": (2, 2), "padding": 1},
                                {"dilation": (1, 1), "stride": 2}])
def test_dilated_conv_matches_jax(rng, kw):
    x, w, b = _layer(rng, (1, 14, 9, 4), 5)
    got = conv_int.conv2d_int8_dilated(torch.from_numpy(x),
                                       torch.from_numpy(w),
                                       torch.from_numpy(b), **kw)
    _same(got, j_int.conv2d_int8_dilated(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), **kw))


def test_rewrites_match_jax(rng):
    """The s4d and tapn weight rewrites and space_to_depth4 == JAX's."""
    w = _int8(rng, (6, 5, 5, 4), -8, 8)
    _same(conv_fast.conv_weights_s4d(w), j_fast.conv_weights_s4d(w))
    _same(conv_fast.deconv_weights_tapn(w), j_fast.deconv_weights_tapn(w))
    x = _int8(rng, (2, 8, 12, 3))
    xs = conv_fast.space_to_depth4(torch.from_numpy(x))
    _same(xs, j_fast.space_to_depth4(jnp.asarray(x)))
    with pytest.raises(ValueError, match="multiples of 4"):
        conv_fast.space_to_depth4(torch.from_numpy(x[:, :6]))


def test_laxf32_refuses_wide_layers(rng):
    """k*k*I*128*128 above 2^24 is refused, as in JAX: layer 1 (I = 128)."""
    x, w, b = _layer(rng, (1, 8, 8, 128), 4)
    with pytest.raises(AssertionError):
        j_int.conv2d_int8_f32(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    with pytest.raises(AssertionError):
        conv_int.conv2d_int8_f32(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b))
    p = codec_int.random_params(reference_net_for_input(64, 64), 0)
    with pytest.raises(AssertionError):
        codec_int.eight_layers_net(
            p, torch.zeros((1, 64, 64, 3), dtype=torch.uint8),
            reference_net_for_input(64, 64), impl=("laxf32",) * 4
            + ("dilated",) * 4)


def test_random_params_match_jax():
    for seed in (0, 7):
        got = codec_int.random_params(seed=seed)
        ref = j_net.random_params(seed=seed)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert got[k].dtype == torch.int8
            _same(got[k], v)


@pytest.fixture(scope="module")
def net_case():
    """Seeded random weights and a 64x64 uint8 batch, and the JAX golden."""
    p = j_net.random_params(seed=5)
    x = np.random.default_rng(6).integers(0, 256, size=(2, 64, 64, 3),
                                          dtype=np.uint8)
    golden = np.asarray(j_net.eight_layers_net(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x.view(np.int8)), j_geometry(64, 64), phased=False))
    return codec_int.random_params(seed=5), x, golden


@pytest.mark.parametrize("plan", list(PLANS))
def test_net_under_plan_matches_jax(net_case, plan):
    """The whole net under each new plan == the JAX net under the same
    plan, and == the golden."""
    tp, x, golden = net_case
    got = codec_int.eight_layers_net(tp, torch.from_numpy(x),
                                     reference_net_for_input(64, 64),
                                     impl=PLANS[plan])
    ref = j_net.eight_layers_net(
        {k: jnp.asarray(v.numpy()) for k, v in tp.items()},
        jnp.asarray(x.view(np.int8)), j_geometry(64, 64), impl=PLANS[plan])
    _same(got, ref)
    _same(got, golden)


def test_phased_false_is_the_golden_plan(net_case):
    tp, x, golden = net_case
    cfg = reference_net_for_input(64, 64)
    runs = (cuda_conv.conv3x3_s1_int8.plain_runs,
            cuda_conv.conv_sparse_int8.plain_runs)
    got = codec_int.eight_layers_net(tp, torch.from_numpy(x), cfg,
                                     phased=False)
    assert runs == (cuda_conv.conv3x3_s1_int8.plain_runs,
                    cuda_conv.conv_sparse_int8.plain_runs)
    _same(got, golden)
    # phased=False leaves an explicit plan alone, as in JAX
    _same(codec_int.eight_layers_net(tp, torch.from_numpy(x), cfg,
                                     phased=False, impl=PLANS["gemm_tapn"]),
          golden)
