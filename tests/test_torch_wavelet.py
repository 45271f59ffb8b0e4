"""The port's wavelet integer codec against the JAX package's, on the CPU,
for each of the four profiles at 64x96 and B = 2: the Haar weights, the
host and device wire and display maps, the golden wavelet output, the
containers (byte-identical), decoding across the two packages, and
``roundtrip_metrics``.  Every comparison is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_image_compression_network_tpu import intnet_haar as j_haar
from simple_image_compression_network_tpu.codec import wavelet_codec as j_wc
from simple_image_compression_network_tpu_torch import intnet_haar
from simple_image_compression_network_tpu_torch.codec import (
    container, int_codec, wavelet_codec)
from test_wavelet_codec import _smooth_batch

torch.set_num_threads(1)

PROFILES = list(wavelet_codec.PROFILES)


def _det2_drop(profile):
    keep = wavelet_codec.PROFILES[profile]["det2_keep"]
    return () if keep is None else tuple(s for s in range(9)
                                         if s not in keep)


@pytest.fixture(scope="module", params=PROFILES)
def case(request):
    """(profile, JAX codec, port codec, images, JAX containers)."""
    imgs = _smooth_batch()
    jc = j_wc.WaveletCodec(request.param)
    tc = wavelet_codec.WaveletCodec(request.param, device="cpu")
    return request.param, jc, tc, imgs, jc.compress_batch(imgs)


def test_profiles_match_jax():
    assert wavelet_codec.DEFAULT_PROFILE == j_wc.DEFAULT_PROFILE
    assert set(wavelet_codec.PROFILES) == set(j_wc.PROFILES)
    for name, spec in wavelet_codec.PROFILES.items():
        assert spec == {k: j_wc.PROFILES[name][k] for k in spec}


def test_haar_params_match_jax(case):
    profile = case[0]
    keep = wavelet_codec.PROFILES[profile]["det2_keep"]
    ours = intnet_haar.haar_params(det2_keep=keep)
    ref = j_haar.haar_params(det2_keep=keep)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_maps_and_golden_match_jax(case):
    """The numpy maps and the golden wavelet against the JAX package's,
    the device maps (on the CPU) against the numpy maps, and the golden
    against the port's net."""
    profile, jc, tc, imgs, _ = case
    np.testing.assert_array_equal(intnet_haar.to_wire(imgs),
                                  j_haar.to_wire(imgs))
    np.testing.assert_array_equal(intnet_haar.to_wire_ycocg(imgs),
                                  j_haar.to_wire_ycocg(imgs))
    wire = tc.to_wire(imgs)
    np.testing.assert_array_equal(wire, jc.to_wire(imgs))
    np.testing.assert_array_equal(tc._wire_dev(imgs).numpy(), wire)
    np.testing.assert_array_equal(np.asarray(jc._wire_dev(imgs)), wire)
    y = tc.net(torch.from_numpy(wire)).numpy()
    golden = intnet_haar.golden_wavelet(
        imgs, det2_drop=_det2_drop(profile),
        wire=wire if tc.wire == "ycocg" else None)
    np.testing.assert_array_equal(golden, j_haar.golden_wavelet(
        imgs, det2_drop=_det2_drop(profile),
        wire=wire if tc.wire == "ycocg" else None))
    np.testing.assert_array_equal(y, golden)
    np.testing.assert_array_equal(intnet_haar.display(y), j_haar.display(y))
    np.testing.assert_array_equal(intnet_haar.display_ycocg(y),
                                  j_haar.display_ycocg(y))
    rec = tc.display(y)
    np.testing.assert_array_equal(rec, jc.display(y))
    np.testing.assert_array_equal(tc._display_dev(torch.from_numpy(y))
                                  .numpy(), rec)


def test_containers_byte_identical(case):
    _, _, tc, imgs, blobs = case
    ours = tc.compress_batch(imgs)
    assert ours == blobs
    assert all(container.unpack(b)[0] == container.CODEC_INT8 for b in ours)
    # the device coder's plain version writes the same bytes
    assert int_codec.compress_batch(tc.net, tc._wire_dev(imgs),
                                    static_cdfs=tc.cdfs) == blobs


def test_containers_cross_decode(case):
    _, jc, tc, imgs, blobs = case
    rec, x_hat = tc.decompress_batch(blobs)
    j_rec, j_x = jc.decompress_batch(tc.compress_batch(imgs))
    np.testing.assert_array_equal(x_hat.numpy(), np.asarray(j_x))
    np.testing.assert_array_equal(rec, j_rec)
    rec_dev, _ = tc.decompress_batch_device(blobs)
    assert rec_dev.dtype == torch.uint8
    np.testing.assert_array_equal(rec_dev.numpy(), rec)


def test_roundtrip_metrics_match_jax(case):
    _, jc, tc, imgs, _ = case
    got = tc.roundtrip_metrics(imgs)
    assert got == jc.roundtrip_metrics(imgs)
    assert got["decode_bit_exact"]


def test_device_maps_on_jax_inputs():
    """The device maps against the JAX package's jitted ones on every uint8
    colour and on net outputs over the whole int8 range, border included."""
    rng = np.random.default_rng(11)
    v = np.arange(256, dtype=np.uint8)
    cube = np.stack(np.meshgrid(v, v[::5], v[::3], indexing="ij"),
                    -1).reshape(1, 256, -1, 3)[:, :, :1024]
    y = rng.integers(-128, 128, size=(2, 16, 24, 3), dtype=np.int8)
    for profile in ("haar-rgb", "haar422"):
        jc = j_wc.WaveletCodec(profile)
        tc = wavelet_codec.WaveletCodec(profile, device="cpu")
        np.testing.assert_array_equal(tc._wire_dev(cube).numpy(),
                                      np.asarray(jc._wire_dev(cube)))
        np.testing.assert_array_equal(
            tc._display_dev(torch.from_numpy(y)).numpy(),
            np.asarray(jc._display_dev(jnp.asarray(y))))
        np.testing.assert_array_equal(
            tc._display_dev(torch.from_numpy(y)).numpy(), tc.display(y))
