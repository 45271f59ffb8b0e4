"""The port's rANS coder (simple_image_compression_network_tpu_torch.codec)
against the JAX package: golden ilrans bytes, the lax.scan coder and the
Pallas kernels in interpret mode.  Exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_image_compression_network_tpu.codec import device_rans as j_dev
from simple_image_compression_network_tpu.codec import entropy, ilrans
from simple_image_compression_network_tpu.codec import pallas_rans
from simple_image_compression_network_tpu_torch.codec import cuda_rans
from simple_image_compression_network_tpu_torch.codec import device_rans
from simple_image_compression_network_tpu_torch.codec import ilrans as t_il

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    """4 streams x 16 steps x 48 lanes (lane k codes channel k % 24)."""
    rng = np.random.default_rng(21)
    c, lm, t_steps, s = 24, 2, 16, 4
    n_lanes = c * lm
    cdf = np.stack([entropy.quantize_cdf(rng.dirichlet(np.ones(129) * 0.25))
                    for _ in range(c)])
    lane_cdf = np.ascontiguousarray(cdf[np.arange(n_lanes) % c], np.int32)
    ctx = np.tile(np.arange(c, dtype=np.int32), t_steps * lm)
    syms = np.minimum(rng.geometric(0.3, (s, t_steps, n_lanes)) - 1,
                      127).astype(np.int8)
    streams = [ilrans.encode(syms[j].ravel(), ctx, cdf, n_lanes=n_lanes)
               for j in range(s)]
    return lane_cdf, syms, streams


def _port_encode(lane_cdf, syms):
    words, counts = cuda_rans.encode_batch_compact(torch.from_numpy(syms),
                                                   torch.from_numpy(lane_cdf))
    return words.numpy().view(np.uint16), counts.numpy()


def test_encode_matches_golden_and_scan(case):
    lane_cdf, syms, streams = case
    words, counts = _port_encode(lane_cdf, syms)
    off = ilrans.unpack_header(streams[0])[3]
    s_words, s_counts = jax.vmap(
        lambda sy: j_dev.encode(sy, jnp.asarray(lane_cdf), None))(
            jnp.asarray(syms.astype(np.int32)))
    np.testing.assert_array_equal(counts, np.asarray(s_counts))
    np.testing.assert_array_equal(words, np.asarray(s_words))
    for j, blob in enumerate(streams):
        assert words[j, :counts[j]].astype("<u2").tobytes() == blob[off:]


def test_encode_matches_pallas_compact(case):
    lane_cdf, syms, _ = case
    words, counts = _port_encode(lane_cdf, syms)
    p_words, p_counts = pallas_rans.encode_batch_compact(
        jnp.asarray(syms.astype(np.int32)), jnp.asarray(lane_cdf),
        cap_words=2048, interpret=True)
    p_words, p_counts = np.asarray(p_words), np.asarray(p_counts)
    np.testing.assert_array_equal(counts, p_counts)
    for j in range(len(counts)):
        np.testing.assert_array_equal(words[j, :counts[j]],
                                      p_words[j, :counts[j]])


def test_encode_batch_matches_pallas_and_compact(case):
    """The dense-flag encoder (kernel H's plain version, then the stream
    assembly) == the JAX package's ``encode_batch`` in interpret mode and,
    over each stream's count, the port's compact encoder."""
    lane_cdf, syms, _ = case
    runs = cuda_rans.encode_dense.plain_runs
    words, counts = cuda_rans.encode_batch(torch.from_numpy(syms),
                                           torch.from_numpy(lane_cdf))
    assert cuda_rans.encode_dense.plain_runs == runs + 1
    assert cuda_rans.encode_dense.launches == 0
    p_words, p_counts = pallas_rans.encode_batch(
        jnp.asarray(syms.astype(np.int32)), jnp.asarray(lane_cdf),
        interpret=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(p_counts))
    np.testing.assert_array_equal(words.numpy(), np.asarray(p_words))
    c_words, c_counts = _port_encode(lane_cdf, syms)
    np.testing.assert_array_equal(counts.numpy(), c_counts)
    for j in range(len(c_counts)):
        np.testing.assert_array_equal(words.numpy()[j, :c_counts[j]],
                                      c_words[j, :c_counts[j]])
    emits, needs, x_fin = cuda_rans.encode_dense(
        torch.from_numpy(syms.astype(np.int32)), torch.from_numpy(lane_cdf))
    assert emits.dtype == x_fin.dtype == torch.int32
    assert needs.dtype == torch.bool and needs.shape == syms.shape
    np.testing.assert_array_equal(
        x_fin.numpy().view(np.uint32),
        (words.numpy()[:, 0:2 * lane_cdf.shape[0]:2] << 16)
        | words.numpy()[:, 1:2 * lane_cdf.shape[0]:2])


def test_encode_batch_rejects_bad_input(case):
    lane_cdf, syms, _ = case
    lc = torch.from_numpy(lane_cdf)
    with pytest.raises(ValueError):
        cuda_rans.encode_batch(torch.from_numpy(syms).to(torch.int64), lc)
    with pytest.raises(ValueError):
        cuda_rans.encode_batch(torch.from_numpy(syms), lc[:5])
    with pytest.raises(ValueError):
        cuda_rans.encode_batch(torch.from_numpy(syms[0]), lc)


def _word_matrix(streams):
    off = ilrans.unpack_header(streams[0])[3]
    counts = np.asarray([(len(b) - off) // 2 for b in streams], np.int32)
    cap = int(counts.max())
    words = np.stack([np.pad(np.frombuffer(b, "<u2", offset=off),
                             (0, cap - c)) for b, c in zip(streams, counts)])
    return words, counts


def test_decode_matches_scan_and_pallas(case):
    lane_cdf, syms, streams = case
    words, counts = _word_matrix(streams)
    n_lanes, t_steps = lane_cdf.shape[0], syms.shape[1]
    wt = torch.from_numpy(words.view(np.int16))
    x0 = cuda_rans.split_init(wt, n_lanes)
    out, cons, xfin = cuda_rans.decode(wt, x0, torch.from_numpy(lane_cdf),
                                       t_steps)
    np.testing.assert_array_equal(out.numpy(), syms)
    np.testing.assert_array_equal(cons.numpy(), counts)
    assert (xfin.numpy() == ilrans.STATE_LB).all()

    wj = jnp.asarray(words)
    jx0 = pallas_rans.split_init(wj, n_lanes)
    np.testing.assert_array_equal(x0.numpy().view(np.uint32), np.asarray(jx0))
    p_out, p_cons, p_xfin = pallas_rans.decode(
        wj, jx0, jnp.asarray(lane_cdf), t_steps=t_steps, interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(p_out))
    np.testing.assert_array_equal(cons.numpy(), np.asarray(p_cons).ravel())
    np.testing.assert_array_equal(xfin.numpy().view(np.uint32),
                                  np.asarray(p_xfin))
    for j in range(len(streams)):
        s_out, s_cons, s_xfin = j_dev.decode(wj[j], jnp.asarray(lane_cdf),
                                             None, t_steps=t_steps)
        np.testing.assert_array_equal(out.numpy()[j], np.asarray(s_out))
        assert int(cons[j]) == int(s_cons)
        np.testing.assert_array_equal(xfin.numpy()[j].view(np.uint32),
                                      np.asarray(s_xfin))


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_word_select_property(density):
    """w[s, l] = words[s, pos[s] + rank[s, l]] for every lane that renorms,
    rank being the exclusive prefix sum of the renorm mask; reads past the
    buffer give 0 (the port's form of the TPU's butterfly property)."""
    rng = np.random.default_rng(7)
    s, n, cap = 4, 256, 700
    need = rng.uniform(size=(s, n)) < density
    rank = np.cumsum(need, axis=1) - need
    words = rng.integers(0, 1 << 16, size=(s, cap))
    pos = rng.integers(0, cap, size=s)
    got = device_rans.select_words(torch.from_numpy(words),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(rank)).numpy()
    idx = pos[:, None] + rank
    padded = np.concatenate([words, np.zeros((s, n), words.dtype)], axis=1)
    expect = np.take_along_axis(padded, idx, axis=1)
    np.testing.assert_array_equal(got[need], expect[need])


def test_corrupt_stream_is_detected_without_overrun(case):
    """A truncated buffer: reads past it give 0 and the stream fails the
    consumed / final-state check instead of reading out of bounds."""
    lane_cdf, syms, streams = case
    words, counts = _word_matrix(streams)
    cut = torch.from_numpy(words[:, : 2 * lane_cdf.shape[0] + 5].view(
        np.int16)).contiguous()
    x0 = cuda_rans.split_init(cut, lane_cdf.shape[0])
    _, cons, xfin = cuda_rans.decode(cut, x0, torch.from_numpy(lane_cdf),
                                     syms.shape[1])
    ok = (cons.numpy() == counts) & (xfin.numpy() == ilrans.STATE_LB).all(1)
    assert not ok.any()


def test_wrappers_reject_bad_input(case):
    lane_cdf, syms, _ = case
    lc = torch.from_numpy(lane_cdf)
    with pytest.raises(ValueError):
        cuda_rans.encode_batch_compact(torch.from_numpy(syms).to(torch.int32),
                                       lc)
    with pytest.raises(ValueError):
        cuda_rans.encode_batch_compact(torch.from_numpy(syms), lc[:5])
    words = torch.zeros((2, 300), dtype=torch.int16)
    with pytest.raises(ValueError):
        cuda_rans.decode(words.to(torch.int32),
                         torch.zeros((2, 48), dtype=torch.int32), lc, 4)


def test_header_and_helpers_match_jax():
    assert t_il.pack_header(1234, 384, 16) == ilrans.pack_header(1234, 384,
                                                                 16)
    assert t_il.unpack_header(ilrans.pack_header(7, 48, 16)) == \
        ilrans.unpack_header(ilrans.pack_header(7, 48, 16))
    assert t_il.STATE_LB == ilrans.STATE_LB and t_il.MAGIC == ilrans.MAGIC
    for n in (1, 4096, 4097, 30000):
        assert device_rans.bucket_words(n) == j_dev.bucket_words(n)
    data = np.arange(10, dtype="<u2").tobytes()
    np.testing.assert_array_equal(device_rans.words_from_bytes(data, 16),
                                  j_dev.words_from_bytes(data, 16))
    w = np.arange(24, dtype=np.uint16).reshape(2, 12)
    c = np.asarray([5, 12])
    assert device_rans.streams_from_words(w, c, 40, 4) == \
        j_dev.streams_from_words(w, c, 40, 4)
