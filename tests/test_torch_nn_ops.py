"""The port's capability-parity ops (``ops/nn.py``) and its TMR checker
(``ops/tmr.py``) against the JAX package's, on the CPU, from numpy-seeded
inputs.  Every comparison is exact (integers, tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_image_compression_network_tpu.ops import nn as j_nn
from simple_image_compression_network_tpu.ops import tmr as j_tmr
from simple_image_compression_network_tpu_torch.ops import conv_int, nn, tmr

torch.set_num_threads(1)


def _same(got, ref) -> None:
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, got.dtype, ref.shape, ref.dtype)
    np.testing.assert_array_equal(got, ref)


def _pair(a):
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a)


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, size=shape, dtype=np.int8)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int32, np.float32])
@pytest.mark.parametrize("k,stride", [(2, None), (3, None), (3, 2)])
def test_maxpool2d_matches_jax(rng, dtype, k, stride):
    """VALID windows: the partial windows at the edges (7 % 2, 7 % 3) are
    dropped, as reduce_window's "VALID" drops them."""
    x = rng.integers(-128, 128, size=(2, 7, 8, 3)).astype(dtype)
    t, j = _pair(x)
    _same(nn.maxpool2d(t, k, stride), j_nn.maxpool2d(j, k, stride))


def test_pools_match_jax(rng):
    x = _int8(rng, (2, 9, 4))
    t, j = _pair(x)
    _same(nn.maxpool1d(t, 2), j_nn.maxpool1d(j, 2))
    xb = rng.integers(0, 3, size=(1, 5, 6, 2), dtype=np.uint8)
    t, j = _pair(xb)
    _same(nn.binary_maxpool2d(t, 2), j_nn.binary_maxpool2d(j, 2))
    x4 = _int8(rng, (2, 7, 6, 3))
    t, j = _pair(x4)
    for shift in (0, 2):
        _same(nn.avgpool2d_quant(t, 2, shift=shift),
              j_nn.avgpool2d_quant(j, 2, shift=shift))
    _same(nn.accpool(t), j_nn.accpool(j))
    _same(nn.relu_batch(t), j_nn.relu_batch(j))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_label_select_matches_jax_with_ties(rng, dtype):
    """Equal scores come out lower index first, as lax.top_k gives them."""
    x = rng.integers(-3, 3, size=(6, 17)).astype(dtype)
    x[0] = 1
    t, j = _pair(x)
    for k in (1, 5, 17):
        _same(nn.label_select(t, k), j_nn.label_select(j, k))


@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 1)])
def test_depthwise_matches_jax(rng, stride, padding):
    x = rng.integers(0, 256, size=(2, 7, 6, 5), dtype=np.uint8).view(np.int8)
    w = _int8(rng, (5, 3, 3), -8, 8)
    b = _int8(rng, (5,))
    (tx, jx), (tw, jw), (tb, jb) = _pair(x), _pair(w), _pair(b)
    _same(nn.depthwise_conv2d_int8(tx, tw, tb, stride=stride,
                                   padding=padding),
          j_nn.depthwise_conv2d_int8(jx, jw, jb, stride=stride,
                                     padding=padding))


@pytest.mark.parametrize("bias,relu", [(True, True), (True, False),
                                       (False, True)])
def test_fc_int8_matches_jax(rng, bias, relu):
    x = _int8(rng, (3, 200))
    w = _int8(rng, (7, 200), -8, 8)
    b = _int8(rng, (7,))
    (tx, jx), (tw, jw) = _pair(x), _pair(w)
    tb, jb = _pair(b) if bias else (None, None)
    _same(nn.fc_int8(tx, tw, tb, relu=relu),
          j_nn.fc_int8(jx, jw, jb, relu=relu))


def test_threshold_and_channelwise_match_jax(rng):
    x = rng.integers(-300, 300, size=(2, 5, 4), dtype=np.int32)
    th = np.sort(rng.integers(-300, 300, size=(4, 6), dtype=np.int32), -1)
    (tx, jx), (tt, jt) = _pair(x), _pair(th)
    _same(nn.threshold_activation(tx, tt), j_nn.threshold_activation(jx, jt))
    a = _int8(rng, (2, 3, 4))
    p = _int8(rng, (4,))
    (ta, ja), (tp, jp) = _pair(a), _pair(p)
    for op in ("add", "mul"):
        _same(nn.channelwise_op(ta, tp, op), j_nn.channelwise_op(ja, jp, op))
    with pytest.raises(ValueError):
        nn.channelwise_op(ta, tp, "sub")


def test_binary_ops_match_jax(rng):
    x = rng.integers(0, 2, size=(3, 70)).astype(np.int8)
    w = rng.integers(0, 2, size=(4, 70)).astype(np.int8)
    (tx, jx), (tw, jw) = _pair(x), _pair(w)
    _same(nn.xnor_popcount_fc(tx, tw), j_nn.xnor_popcount_fc(jx, jw))
    _same(nn.binary_fc(tx, tw), j_nn.binary_fc(jx, jw))


def test_stream_utils_match_jax(rng):
    a, b = _int8(rng, (4, 9)), _int8(rng, (4, 9))
    (ta, ja), (tb, jb) = _pair(a), _pair(b)
    _same(nn.add_streams(ta, tb), j_nn.add_streams(ja, jb))
    d0, d1 = nn.duplicate_streams(ta)
    assert d0 is ta and d1 is ta
    _same(nn.streaming_cast(ta, torch.int32),
          j_nn.streaming_cast(ja, jnp.int32))


def _tmr_case(rng):
    x = rng.integers(0, 256, size=(2, 8, 6, 3), dtype=np.uint8).view(np.int8)
    return x, _int8(rng, (4, 5, 5, 3), -8, 8), _int8(rng, (4,))


def test_triplicate_and_check_match_jax(rng):
    _, w, b = _tmr_case(rng)
    got = tmr.triplicate_weights(torch.from_numpy(w), torch.from_numpy(b))
    for g, r in zip(got, j_tmr.triplicate_weights(jnp.asarray(w),
                                                  jnp.asarray(b))):
        _same(g, r)
    # every agreement pattern of three replicas: all, one off, none
    y = rng.integers(0, 3, size=(5, 7, 12)).astype(np.int8)
    voted, err = tmr.tmr_check(torch.from_numpy(y))
    jv, je = j_tmr.tmr_check(jnp.asarray(y))
    _same(voted, jv)
    assert err.dtype == torch.int32 and err.dim() == 0
    assert int(err) == int(je) == 3


@pytest.mark.parametrize("fault", ["none", "one", "all"])
def test_conv_tmr_matches_jax(rng, fault):
    """No fault: flag 0; one replica flipped: flag 1 and the vote
    unchanged; the three replicas made distinct: flag 2, replica a."""
    x, w, b = _tmr_case(rng)
    mask = np.zeros((2, 4, 3, 12), np.int32)
    if fault == "one":
        mask[0, 1, 1, 0] = 0x7F
    elif fault == "all":
        mask[1, 0, 2, 3] = 0x11
        mask[1, 0, 2, 4] = 0x22
    kw = {} if fault == "none" else {"fault_mask": mask}
    voted, err = tmr.conv2d_int8_tmr(
        torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(x),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    jv, je = j_tmr.conv2d_int8_tmr(jnp.asarray(w), jnp.asarray(b),
                                   jnp.asarray(x),
                                   **{k: jnp.asarray(v)
                                      for k, v in kw.items()})
    _same(voted, jv)
    assert int(err) == int(je) == {"none": 0, "one": 1, "all": 2}[fault]
    clean = conv_int.conv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b))
    if fault != "all":
        _same(voted, clean.numpy())
