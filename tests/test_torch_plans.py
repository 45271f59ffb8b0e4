"""The port's int8 transform under the JAX package's Pallas plans, the
kernel behind each plan (A with its halo modes, the block-sparse F) and the
tiled transform, against the JAX package on the CPU.  Pallas kernels run in
interpret mode, as the JAX package's own tests run them; every comparison
is exact (integers)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_image_compression_network_tpu.config import (
    reference_net_for_input as j_geometry)
from simple_image_compression_network_tpu.models import codec_int as j_net
from simple_image_compression_network_tpu.models import tiled as j_tiled
from simple_image_compression_network_tpu.ops import pallas_conv
from simple_image_compression_network_tpu.utils import weights_io as j_io
from simple_image_compression_network_tpu_torch.config import (
    reference_net_for_input)
from simple_image_compression_network_tpu_torch.models import codec_int
from simple_image_compression_network_tpu_torch.models import tiled
from simple_image_compression_network_tpu_torch.ops import conv_int
from simple_image_compression_network_tpu_torch.ops import cuda_conv

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "reference_weights.npz")
PLANS = {"pallas3": ("pallas3",) * 4 + ("pd2s3",) * 4,
         "pallas": ("pallas",) * 4 + ("pd2s",) * 4,
         "pallas2": ("pallas2",) * 4 + ("pd2s2",) * 4}


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, size=shape, dtype=np.int8)


@pytest.fixture(scope="module")
def params():
    return j_io.load_checkpoint(CKPT)


@pytest.mark.parametrize("jax_kernel", ["conv3x3_s1_int8",
                                        "conv3x3_s1_int8_flat"])
@pytest.mark.parametrize("x_valid,y_valid", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_conv3x3_halo_modes_match_pallas(rng, jax_kernel, x_valid, y_valid):
    """Kernel A's plain version (what its wrapper runs on CPU tensors) ==
    both TPU kernels of its contract, SAME and the three halo modes.  X is
    chosen so that the TPU kernels' output has 16 rows: their own grid."""
    x = _int8(rng, (2, 18 if x_valid else 16, 9, 12))
    w3 = _int8(rng, (3, 3, 12, 16), -8, 8)
    b = _int8(rng, (16,))
    runs = cuda_conv.conv3x3_s1_int8.plain_runs
    got = cuda_conv.conv3x3_s1_int8_any(
        torch.from_numpy(x), torch.from_numpy(w3), torch.from_numpy(b),
        x_valid=x_valid, y_valid=y_valid)
    assert cuda_conv.conv3x3_s1_int8.plain_runs == runs + 1
    ref = getattr(pallas_conv, jax_kernel)(
        jnp.asarray(x), jnp.asarray(w3), jnp.asarray(b), x_valid=x_valid,
        y_valid=y_valid, interpret=True)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("layer,shape,o,valid", [
    ("conv", (2, 32, 24, 128), 192, False),
    ("deconv", (2, 16, 8, 192), 128, False),
    ("conv", (2, 36, 28, 128), 128, True),
    ("deconv", (2, 18, 10, 128), 128, True),
    ("conv", (2, 16, 12, 3), 128, False),      # ci = 3: JAX falls back
    ("deconv", (2, 8, 6, 128), 3, False),      # o = 3: JAX falls back
])
def test_pallas3_layers_match_jax(rng, layer, shape, o, valid):
    """Kernel F's layers (plain version) == the JAX package's block-sparse
    layers in interpret mode, where the JAX side's own fallbacks to the
    dense kernels must give the same integers too."""
    lo = -128 if layer == "conv" else 0
    x = _int8(rng, shape, lo)
    w = _int8(rng, (o, 5, 5, shape[3]), -8, 8)
    b = _int8(rng, (o,))
    name = f"{layer}2d_int8_pallas3"
    runs = cuda_conv.conv_sparse_int8.plain_runs
    got = getattr(cuda_conv, name)(torch.from_numpy(x), w, b, x_valid=valid,
                                   y_valid=valid)
    assert cuda_conv.conv_sparse_int8.plain_runs == runs + 1
    assert cuda_conv.conv_sparse_int8.launches == 0
    ref = getattr(pallas_conv, name)(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), x_valid=valid,
                                     y_valid=valid, interpret=True)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("plan", ["pallas", "pallas2"])
@pytest.mark.parametrize("layer", ["conv", "deconv"])
def test_dense_pallas_layers_match_jax(rng, plan, layer):
    """conv2d/deconv2d_int8_pallas{,2} (kernel A) == the JAX package's, in
    interpret mode, at the shapes of its own tests."""
    if layer == "conv":
        x = rng.integers(0, 256, size=(1, 16, 12, 3),
                         dtype=np.uint8).view(np.int8)
        w = _int8(rng, (8, 5, 5, 3), -8, 8)
        b = _int8(rng, (8,))
    else:
        x = _int8(rng, (1, 8, 6, 4), 0)
        w = _int8(rng, (6, 5, 5, 4), -8, 8)
        b = _int8(rng, (6,))
    name = f"{layer}2d_int8_{plan}"
    got = getattr(cuda_conv, name)(torch.from_numpy(x), w, b)
    ref = getattr(pallas_conv, name)(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), tx=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sparse_halo_modes_crop_the_same_layer(rng):
    """Kernel F's halo modes are the SAME layer's interior: a conv input
    with a 2-pixel halo on one axis, a deconv input with a 1-pixel halo on
    the other, against the port's float64 goldens cropped."""
    x = torch.from_numpy(_int8(rng, (2, 20, 12, 8)))
    w = torch.from_numpy(_int8(rng, (6, 5, 5, 8), -8, 8))
    b = torch.from_numpy(_int8(rng, (6,)))
    full = conv_int.conv2d_int8(x, w, b)
    got = cuda_conv.conv2d_int8_pallas3(x, w, b, x_valid=True)
    np.testing.assert_array_equal(got.numpy(), full[:, 1:-1].numpy())
    fulld = conv_int.deconv2d_int8(x, w, b)
    gotd = cuda_conv.deconv2d_int8_pallas3(x, w, b, y_valid=True)
    np.testing.assert_array_equal(gotd.numpy(), fulld[:, :, 2:-2].numpy())


def test_sparse_tap_tables():
    """25 real taps per layer form: the conv's four input phase blocks
    (9/6/6/4 taps) feed one output block; the deconv's one input block
    feeds four output phases (9/6/6/4 taps); sorted by (oblk, cblk)."""
    w = np.zeros((2, 5, 5, 3), np.int8)
    for taps, key in ((cuda_conv.conv_taps_s2d(w)[0], 2),
                      (cuda_conv.deconv_taps_d2s(w)[0], 3)):
        assert len(taps) == 25
        per = [sum(1 for e in taps if e[key] == k) for k in range(4)]
        assert per == [9, 6, 6, 4]
        assert [(e[3], e[2]) for e in taps] == sorted((e[3], e[2])
                                                      for e in taps)
        assert sorted(e[4] for e in taps) == list(range(25))


def test_sparse_wrapper_rejects_bad_input(rng):
    x = torch.from_numpy(_int8(rng, (1, 4, 4, 8)))
    wt = torch.from_numpy(_int8(rng, (2, 4, 5), -8, 8))
    b = torch.from_numpy(_int8(rng, (5,)))
    taps = ((1, 1, 0, 0, 0), (0, 1, 1, 0, 1))
    assert cuda_conv.conv_sparse_int8(x, wt, b, taps, 1).shape == (1, 4, 4, 5)
    for bad in (((3, 1, 0, 0, 0),), ((1, 1, 2, 0, 0),), ((1, 1, 0, 1, 0),),
                ((1, 1, 0, 0, 2),), ((1, 1, 1, 0, 0), (1, 1, 0, 0, 1)),
                ((1, 1, 0, 0, 0),) * 33, ()):
        with pytest.raises(ValueError):
            cuda_conv.conv_sparse_int8(x, wt, b, bad, 1)
    with pytest.raises(TypeError):
        cuda_conv.conv_sparse_int8(x.to(torch.int32), wt, b, taps, 1)
    with pytest.raises(ValueError):
        cuda_conv.conv_sparse_int8(x, wt, b[:4], taps, 1)
    with pytest.raises(ValueError):
        cuda_conv.conv_sparse_int8(x.to("meta"), wt.to("meta"), b.to("meta"),
                                   taps, 1)
    with pytest.raises(ValueError):
        cuda_conv.conv2d_int8_pallas3(x[:, :3], np.zeros((2, 5, 5, 8),
                                                         np.int8),
                                      np.zeros(2, np.int8))


@pytest.mark.parametrize("plan", list(PLANS))
def test_plans_match_jax(params, plan):
    """The whole slice: eight_layers_net under each Pallas plan, port
    against JAX (off a TPU the JAX plans lower to plain XLA forms), with
    the reference weights at 128x128."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(1, 128, 128, 3), dtype=np.uint8)
    ref = j_net.eight_layers_net(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x.view(np.int8)), j_geometry(128, 128),
        impl=PLANS[plan])
    got = codec_int.eight_layers_net(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), reference_net_for_input(128, 128),
        impl=PLANS[plan])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_tiled_matches_jax(params):
    """eight_layers_net_tiled under the pallas3 plan at 256x64, tiles of
    64 rows: equal to the JAX package's tiled net and to the untiled net;
    analysis_tiled equal to the untiled analysis."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, size=(1, 256, 64, 3), dtype=np.uint8)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    got = tiled.eight_layers_net_tiled(tp, xt, 64, impl=PLANS["pallas3"])
    ref = j_tiled.eight_layers_net_tiled(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x.view(np.int8)), tile_x=64, impl=PLANS["pallas3"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    cfg = reference_net_for_input(256, 64)
    np.testing.assert_array_equal(
        got.numpy(), codec_int.eight_layers_net(tp, xt, cfg).numpy())
    np.testing.assert_array_equal(
        tiled.analysis_tiled(tp, xt, 64).numpy(),
        codec_int.analysis_int8(tp, xt, cfg).numpy())
    with pytest.raises(ValueError):
        tiled.eight_layers_net_tiled(tp, xt, 40)


@pytest.mark.parametrize("name", ["laxf32", "s4d", "gemm", "phased", "tapn"])
def test_unported_plan_names_raise(name):
    """The five plan names the port once refused now run: the default plan
    with one slot set to the name == the JAX net under the same plan, with
    seeded random weights at 64x64.  A name of the wrong kind for its slot
    still raises ValueError."""
    slot = 4 if name in ("phased", "tapn") else 0
    plan = list(codec_int.DEFAULT_PLAN)
    plan[slot] = name
    x = np.random.default_rng(8).integers(0, 256, size=(1, 64, 64, 3),
                                          dtype=np.uint8)
    jp = j_net.random_params(seed=8)
    ref = j_net.eight_layers_net({k: jnp.asarray(v) for k, v in jp.items()},
                                 jnp.asarray(x.view(np.int8)),
                                 j_geometry(64, 64), impl=tuple(plan))
    tp = codec_int.random_params(seed=8)
    got = codec_int.eight_layers_net(tp, torch.from_numpy(x),
                                     reference_net_for_input(64, 64),
                                     impl=plan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        codec_int.eight_layers_net(tp, torch.from_numpy(x),
                                   reference_net_for_input(64, 64),
                                   impl=("pallas3",) * 8)
