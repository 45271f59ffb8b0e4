"""The port's golden contract: its numpy ``ops/integer`` against the JAX
package's, the wrapping-accumulator equivalence, and its native C++ golden
three ways (port native, port numpy, the JAX package's native golden) and
against the port's float64 layers.  Every comparison is exact."""

import os
import shutil

import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu.ops import integer as j_integer
from simple_image_compression_network_tpu.utils import (
    native_golden as j_native)
from simple_image_compression_network_tpu_torch.ops import conv_int, integer
from simple_image_compression_network_tpu_torch.utils import native_golden

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _layer(rng, shape, o, wire=True):
    x = (rng.integers(0, 256, size=shape, dtype=np.uint8) if wire
         else rng.integers(-128, 128, size=shape, dtype=np.int8))
    return (x, rng.integers(-8, 8, size=(o, 5, 5, shape[3]), dtype=np.int8),
            rng.integers(-128, 128, size=(o,), dtype=np.int8))


def test_wrap_and_epilogue_match_jax():
    acc = np.arange(-70000, 70000, 37, dtype=np.int64)
    np.testing.assert_array_equal(integer.wrap_to_int8(acc),
                                  j_integer.wrap_to_int8(acc))
    bias = np.array([-128, -1, 0, 127], np.int8)
    acc4 = acc[:4 * (acc.size // 4)].reshape(-1, 4)
    got = integer.bias_relu_epilogue(acc4, bias)
    assert got.dtype == np.int8 and got.min() >= 0
    np.testing.assert_array_equal(got, j_integer.bias_relu_epilogue(acc4,
                                                                    bias))


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("fn,kw", [
    ("conv2d_golden", {}),
    ("conv2d_golden", {"stride": 1, "padding": 1}),
    ("conv2d_golden_dilated", {}),
    ("conv2d_golden_dilated", {"dilation": (2, 2), "padding": 2}),
    ("deconv2d_golden", {}),
])
def test_goldens_match_jax(rng, fn, kw, wire):
    """uint8 input, and int8 input reinterpreted (not cast) as uint8."""
    x, w, b = _layer(rng, (2, 11, 9, 3), 4, wire)
    got = getattr(integer, fn)(x, w, b, **kw)
    np.testing.assert_array_equal(got, getattr(j_integer, fn)(x, w, b, **kw))


def test_zero_insert_upsample_matches_jax(rng):
    x = rng.integers(0, 256, size=(1, 3, 4, 2), dtype=np.uint8)
    got = integer.zero_insert_upsample(x)
    assert got.shape == (1, 10, 12, 2)
    np.testing.assert_array_equal(got, j_integer.zero_insert_upsample(x))


def test_wide_acc_equals_wrapping_acc(rng):
    """wrap(wide sum) == wrap after every MAC (the reference's int8
    accumulator), at a tiny shape."""
    x, w, b = _layer(rng, (1, 6, 4, 2), 3)
    slow = integer.conv2d_golden_wrapping_acc(x, w, b)
    np.testing.assert_array_equal(integer.conv2d_golden(x, w, b), slow)
    np.testing.assert_array_equal(
        slow, j_integer.conv2d_golden_wrapping_acc(x, w, b))


def test_float64_layers_match_numpy_golden(rng):
    """The port's torch goldens (``conv_int``) == the numpy goldens."""
    x, w, b = _layer(rng, (2, 10, 8, 5), 6)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        conv_int.conv2d_int8(conv_int.to_wire_int8(xt), torch.from_numpy(w),
                             torch.from_numpy(b)).numpy(),
        integer.conv2d_golden(x, w, b))
    np.testing.assert_array_equal(
        conv_int.deconv2d_int8(conv_int.to_wire_int8(xt),
                               torch.from_numpy(w),
                               torch.from_numpy(b)).numpy(),
        integer.deconv2d_golden(x, w, b))
    np.testing.assert_array_equal(
        conv_int.conv2d_int8_dilated(conv_int.to_wire_int8(xt),
                                     torch.from_numpy(w),
                                     torch.from_numpy(b)).numpy(),
        integer.conv2d_golden_dilated(x, w, b))


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native golden cannot be built")


@pytest.mark.parametrize("layer,shape,o", [("conv2d", (2, 12, 10, 5), 7),
                                           ("conv2d", (1, 9, 7, 3), 4),
                                           ("deconv2d", (1, 6, 8, 4), 5)])
def test_native_golden_three_way(rng, gxx, layer, shape, o):
    """Port native == port numpy golden == the JAX package's native golden
    == the port's float64 layer, odd extents included."""
    x, w, b = _layer(rng, shape, o)
    got = getattr(native_golden, layer)(x, w, b)
    np.testing.assert_array_equal(
        got, getattr(integer, f"{layer}_golden")(x, w, b))
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:
        np.testing.assert_array_equal(got, getattr(j_native, layer)(x, w, b))
    torch_layer = getattr(conv_int, f"{layer}_int8")
    np.testing.assert_array_equal(
        got, torch_layer(conv_int.to_wire_int8(torch.from_numpy(x)),
                         torch.from_numpy(w), torch.from_numpy(b)).numpy())
    # int8 input is reinterpreted, as on the wire
    np.testing.assert_array_equal(
        getattr(native_golden, layer)(x.view(np.int8), w, b), got)


def test_native_golden_is_the_ports_own_build(gxx):
    """The port's copy of golden.cpp, built into build/torch_host/, never
    the JAX package's source or library."""
    assert native_golden.SOURCE == os.path.join(
        ROOT, "simple_image_compression_network_tpu_torch", "native",
        "golden.cpp")
    path, _ = native_golden.build()
    assert path.startswith(os.path.join(ROOT, "build", "torch_host") + os.sep)
    assert os.path.realpath(native_golden.load()._name) == \
        os.path.realpath(path)
    with pytest.raises(ValueError):
        native_golden.conv2d(np.zeros((1, 4, 4, 3), np.uint8),
                             np.zeros((2, 5, 5, 4), np.int8),
                             np.zeros(2, np.int8))


def test_native_golden_raises_without_gxx(tmp_path, monkeypatch):
    monkeypatch.setattr(native_golden, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_golden.conv2d(np.zeros((1, 4, 4, 3), np.uint8),
                             np.zeros((2, 5, 5, 3), np.int8),
                             np.zeros(2, np.int8))
