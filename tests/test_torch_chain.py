"""The port's DeviceChain against the JAX package's on the CPU: the decode
window ``mxb``, the words, the counts and both checksums of the three
programs, the in-loop and direct checks, x_hat against the JAX transform,
and the static-output contract.  The JAX chain runs on its scan engines, as
its own tests run it; the static CDFs come from its ``build_static_cdfs``.
At 128x64 the window is the whole word buffer; at 128x128 it is narrower,
so decode reads a copy of the first ``mxb`` columns."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu.codec import device_chain as j_chain
from simple_image_compression_network_tpu.codec import int_codec as j_codec
from simple_image_compression_network_tpu.config import reference_net_for_input
from simple_image_compression_network_tpu.models import codec_int as j_net
from simple_image_compression_network_tpu.utils import weights_io as j_io
from simple_image_compression_network_tpu_torch.codec import device_chain
from simple_image_compression_network_tpu_torch.models import codec_int
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "reference_weights.npz")
# (geometry, whether the decode window is narrower than the word buffer)
GEOMETRIES = [((128, 64), False), ((128, 128), True)]


@pytest.fixture(scope="module")
def params():
    return j_io.load_checkpoint(CKPT)


@pytest.fixture(scope="module")
def net(params):
    return codec_int.IntCodecNet(weights_io.params_from_jax(params),
                                 device="cpu")


@pytest.fixture(scope="module", params=GEOMETRIES,
                ids=lambda g: f"{g[0][0]}x{g[0][1]}")
def case(request, params, net):
    """Two seeded batches of one geometry, the JAX chain and the port's."""
    (xd, yd), narrower = request.param
    rng = np.random.default_rng(11 + xd + yd)
    xs = [rng.integers(0, 256, size=(2, xd, yd, 3), dtype=np.uint8)
          for _ in range(2)]
    cfg = reference_net_for_input(xd, yd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    xj = [jnp.asarray(x.view(np.int8)) for x in xs]
    cdfs = j_codec.build_static_cdfs(jp, [x[:1] for x in xj], cfg)
    jc = j_chain.DeviceChain(jp, cdfs, xj[0], cfg)
    tc = device_chain.DeviceChain(net, cdfs, torch.from_numpy(xs[0]))
    direct = np.asarray(jax.jit(functools.partial(
        j_net.eight_layers_net, cfg=cfg))(jp, xj[0]))
    return dict(xs=xs, xj=xj, jp=jp, jc=jc, tc=tc, direct=direct,
                narrower=narrower)


def _u16(w: torch.Tensor) -> np.ndarray:
    return w.numpy().view(np.uint16)


def test_plan_and_window_match_jax(case):
    jc, tc = case["jc"], case["tc"]
    assert (tc.mxb, tc.s, tc.n_lanes, tc.t_steps, tc.shape) == (
        jc.mxb, jc.s, jc.n_lanes, jc.t_steps, jc.shape)
    width = tc.encode(torch.from_numpy(case["xs"][0]))[0].shape[1]
    assert (tc.mxb < width) == case["narrower"]
    assert (tc._window is not None) == case["narrower"]


@pytest.mark.parametrize("batch", [0, 1])
def test_encode_matches_jax(case, batch):
    jc, tc = case["jc"], case["tc"]
    w, cnt, csum = tc.encode(torch.from_numpy(case["xs"][batch]))
    jw, jcnt, jcsum = jc.encode(case["jp"], case["xj"][batch])
    np.testing.assert_array_equal(_u16(w), np.asarray(jw))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert csum.dtype == torch.int32
    assert int(csum) == int(np.asarray(jcsum)) == int(cnt.sum())


@pytest.mark.parametrize("bad_count", [False, True])
def test_decode_matches_jax(case, bad_count):
    """x_hat equals the JAX transform run directly; both checksums agree,
    also when a stream's count is off by one (ok false: the checksum
    drops the flag)."""
    jc, tc, jp = case["jc"], case["tc"], case["jp"]
    x, xj = case["xs"][0], case["xj"][0]
    w, cnt, _ = tc.encode(torch.from_numpy(x))
    jw, jcnt, _ = jc.encode(jp, xj)
    if bad_count:
        cnt = cnt.clone()
        cnt[0] += 1
        jcnt = jcnt.at[0].add(1)
    x_hat, dsum = tc.decode(w, cnt)
    jx_hat, jdsum = jc.decode(jp, jw, jcnt)
    direct = case["direct"]
    np.testing.assert_array_equal(x_hat.numpy(), direct)
    np.testing.assert_array_equal(x_hat.numpy(), np.asarray(jx_hat))
    assert int(dsum) == int(np.asarray(jdsum))
    assert int(dsum) == int(direct.astype(np.int32).sum()) + (not bad_count)


@pytest.mark.parametrize("batch", [0, 1])
def test_roundtrip_matches_jax(case, batch):
    csum, exact = case["tc"].roundtrip(torch.from_numpy(case["xs"][batch]))
    jcsum, jexact = case["jc"].roundtrip(case["jp"], case["xj"][batch])
    assert exact.dtype == torch.bool and bool(exact)
    assert bool(np.asarray(jexact))
    assert int(csum) == int(np.asarray(jcsum))


def test_check(case):
    assert case["tc"].check(torch.from_numpy(case["xs"][1])) == (True, True)
    assert case["tc"].graph_launches == {}      # nothing captured on a CPU


def test_static_outputs(case):
    """Each program returns the chain's own tensors and the next call
    overwrites them; decode copies words that are not the chain's own."""
    tc = case["tc"]
    x0, x1 = (torch.from_numpy(x) for x in case["xs"])
    w0, c0, s0 = tc.encode(x0)
    kept = w0.clone(), c0.clone(), s0.clone()
    w1, c1, s1 = tc.encode(x1)
    assert w1 is w0 and c1 is c0 and s1 is s0
    assert not torch.equal(w1, kept[0]) and int(s1) != int(kept[2])
    np.testing.assert_array_equal(
        _u16(w1), np.asarray(case["jc"].encode(case["jp"],
                                               case["xj"][1])[0]))
    x_hat, _ = tc.decode(*kept[:2])       # x0's words back in the buffers
    assert torch.equal(w0, kept[0]) and torch.equal(c0, kept[1])
    assert torch.equal(x_hat, tc.net(x0))
    x_hat1, _ = tc.decode(*tc.encode(x1)[:2])
    assert x_hat1 is x_hat
    assert torch.equal(x_hat1, tc.net(x1))
    r0 = tc.roundtrip(x0)
    assert tc.roundtrip(x1)[0] is r0[0]


def test_rejects_other_inputs(case):
    tc = case["tc"]
    x = torch.from_numpy(case["xs"][0])
    with pytest.raises(ValueError, match="as the chain was built for"):
        tc.encode(x.view(torch.int8))
    with pytest.raises(ValueError, match="as the chain was built for"):
        tc.roundtrip(x[:1])
    w, cnt, _ = tc.encode(x)
    with pytest.raises(ValueError, match="as the chain was built for"):
        tc.decode(w[:, :-1].contiguous(), cnt)
    with pytest.raises(ValueError, match="multiples of 16"):
        device_chain.DeviceChain(tc.net, np.zeros((192, 130), np.int32),
                                 x[:, :120])
