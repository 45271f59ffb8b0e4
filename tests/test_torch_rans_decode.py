"""Kernels C and E's plain versions at their edge shapes, against the JAX
package, and the decode wrappers' host-side helpers.

The plain decode (``cuda_rans.decode`` and ``decode_ctx`` on CPU tensors)
is what the card's kernels are held against; here it is held against the
JAX package's Pallas kernels (interpret mode) and its lax.scan decoder at
lane counts off the warp (N = 20, 200), steps where every lane or no lane
renorms, one context row (R = 1), contexts at 0 and R - 1, and truncated
buffers: symbols, words consumed and final states, exactly.  Then the
staged table layouts, the choice of instance by shape, and the caches of
the kernel tables and of the int8 codec's lane table."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu.codec import device_rans as j_dev
from simple_image_compression_network_tpu.codec import entropy as j_ent
from simple_image_compression_network_tpu.codec import pallas_rans
from simple_image_compression_network_tpu_torch.codec import cuda_rans
from simple_image_compression_network_tpu_torch.codec import int_codec

torch.set_num_threads(1)


def _rand_rows(rng, rows: int, n_sym: int) -> np.ndarray:
    return np.stack([j_ent.quantize_cdf(rng.dirichlet(np.ones(n_sym) * 0.3))
                     for _ in range(rows)]).astype(np.int32)


def _draw(rng, rows: np.ndarray, shape) -> np.ndarray:
    """Symbols drawn from each position's row (rows (..., L+1))."""
    u = rng.integers(0, 65536, size=shape)
    return (rows[..., 1:-1] <= u[..., None]).sum(-1)


def _flat_rows(n: int) -> np.ndarray:
    """Rows of 256 symbols of frequency 256: every lane renorms at every
    other step, all lanes at once."""
    return np.tile(np.arange(257, dtype=np.int32) * 256, (n, 1))


def _skewed_rows(n: int) -> np.ndarray:
    """Rows where one symbol has frequency 65535 (symbol 0, or symbol 1
    after a zero-frequency symbol 0: an interior 0), the rest 1 or 0
    (interior 65536s): coding it, no lane renorms for many steps."""
    a = np.concatenate([[0, 65535], np.full(127, 65536)])
    b = np.concatenate([[0, 0, 65535], np.full(126, 65536)])
    return np.stack([a if k % 2 == 0 else b for k in range(n)]).astype(
        np.int32)


LANE_CASES = {
    # name: (S, t, N, rows maker, words kept past the flush or None)
    "n20": (3, 12, 20, None, None),
    "n200": (2, 6, 200, None, None),
    "all_renorm": (2, 10, 64, "flat", None),
    "no_renorm": (2, 12, 40, "skewed", None),
    "truncated": (3, 12, 20, None, 5),
}


def _lane_case(name):
    s, t, n, kind, cut = LANE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if kind == "flat":
        lane_cdf = _flat_rows(n)
        syms = rng.integers(0, 128, size=(s, t, n))
    elif kind == "skewed":
        lane_cdf = _skewed_rows(n)
        syms = np.broadcast_to(np.arange(n) % 2, (s, t, n))
    else:
        lane_cdf = _rand_rows(rng, n, 128)
        syms = _draw(rng, np.broadcast_to(lane_cdf, (s, t, n, 129)),
                     (s, t, n))
    words, counts = cuda_rans.encode_batch_compact(
        torch.from_numpy(np.ascontiguousarray(syms, np.int8)),
        torch.from_numpy(lane_cdf))
    if cut is not None:
        words = words[:, :2 * n + cut].contiguous()
    return lane_cdf, np.asarray(syms), words, counts, t, cut


@pytest.mark.parametrize("name", list(LANE_CASES))
def test_plain_decode_matches_jax_at_edges(name):
    """Kernel C's plain version == the Pallas kernel (interpret mode) and
    the lax.scan decoder, symbols, consumed and final states."""
    lane_cdf, syms, words, counts, t, cut = _lane_case(name)
    n = lane_cdf.shape[0]
    x0 = cuda_rans.split_init(words, n)
    runs = cuda_rans.decode.plain_runs
    out, cons, xfin = cuda_rans.decode(words, x0, torch.from_numpy(lane_cdf),
                                       t)
    assert cuda_rans.decode.plain_runs == runs + 1
    assert out.dtype == torch.int8 and cons.dtype == xfin.dtype == \
        torch.int32
    if cut is None:
        np.testing.assert_array_equal(out.numpy(), syms)
        np.testing.assert_array_equal(cons.numpy(), counts.numpy())
        assert (xfin.numpy() == 1 << 16).all()
    else:
        assert not (cons.numpy() == counts.numpy()).any()
    if name == "all_renorm":   # the case does what its name says
        assert (cons.numpy() == 2 * n + n * (t // 2)).all()
    if name == "no_renorm":
        assert (cons.numpy() == 2 * n).all()

    wj = jnp.asarray(words.numpy().view(np.uint16))
    jx0 = pallas_rans.split_init(wj, n)
    p_out, p_cons, p_xfin = pallas_rans.decode(
        wj, jx0, jnp.asarray(lane_cdf), t_steps=t, interpret=True)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(p_out).astype(np.int8))
    np.testing.assert_array_equal(cons.numpy(), np.asarray(p_cons).ravel())
    np.testing.assert_array_equal(xfin.numpy().view(np.uint32),
                                  np.asarray(p_xfin))
    for j in range(words.shape[0]):
        s_out, s_cons, s_xfin = j_dev.decode(wj[j], jnp.asarray(lane_cdf),
                                             None, t_steps=t)
        np.testing.assert_array_equal(out.numpy()[j],
                                      np.asarray(s_out).astype(np.int8))
        assert int(cons[j]) == int(s_cons)
        np.testing.assert_array_equal(xfin.numpy()[j].view(np.uint32),
                                      np.asarray(s_xfin))


CTX_CASES = {
    # name: (S, t, N, R, words kept past the flush or None)
    "n20_r7": (3, 10, 20, 7, None),
    "n200_r64": (2, 5, 200, 64, None),
    "r1": (2, 10, 37, 1, None),
    "truncated": (3, 10, 20, 7, 5),
}


def _ctx_case(name):
    s, t, n, r, cut = CTX_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    table = _rand_rows(rng, r, 256)
    ctx = rng.integers(0, r, size=(s, t, n)).astype(np.int32)
    ctx[0, :, 0] = 0            # contexts at both ends of the table
    ctx[-1, :, -1] = r - 1
    syms = _draw(rng, table[ctx], (s, t, n)).astype(np.int32)
    words, counts = cuda_rans.encode_batch_compact_ctx(
        torch.from_numpy(syms), torch.from_numpy(table),
        torch.from_numpy(ctx))
    if cut is not None:
        words = words[:, :2 * n + cut].contiguous()
    return table, ctx, syms, words, counts, t, cut


@pytest.mark.parametrize("name", list(CTX_CASES))
def test_plain_decode_ctx_matches_jax_at_edges(name):
    """Kernel E's plain version == the Pallas kernel (interpret mode) and
    the lax.scan decoder, symbols, consumed and final states."""
    table, ctx, syms, words, counts, t, cut = _ctx_case(name)
    n = ctx.shape[2]
    x0 = cuda_rans.split_init(words, n)
    runs = cuda_rans.decode_ctx.plain_runs
    out, cons, xfin = cuda_rans.decode_ctx(
        words, x0, torch.from_numpy(table), torch.from_numpy(ctx), t)
    assert cuda_rans.decode_ctx.plain_runs == runs + 1
    if cut is None:
        np.testing.assert_array_equal(out.numpy(), syms)
        np.testing.assert_array_equal(cons.numpy(), counts.numpy())
    else:
        assert not (cons.numpy() == counts.numpy()).any()

    wj = jnp.asarray(words.numpy().view(np.uint16))
    jx0 = pallas_rans.split_init(wj, n)
    p_out, p_cons, p_xfin = pallas_rans.decode_ctx(
        wj, jx0, jnp.asarray(table), jnp.asarray(ctx), t_steps=t,
        interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(p_out))
    np.testing.assert_array_equal(cons.numpy(), np.asarray(p_cons).ravel())
    np.testing.assert_array_equal(xfin.numpy().view(np.uint32),
                                  np.asarray(p_xfin))
    for j in range(words.shape[0]):
        s_out, s_cons, s_xfin = j_dev.decode(
            wj[j], jnp.asarray(table), jnp.asarray(ctx[j]), t_steps=t)
        np.testing.assert_array_equal(out.numpy()[j], np.asarray(s_out))
        assert int(cons[j]) == int(s_cons)
        np.testing.assert_array_equal(xfin.numpy()[j].view(np.uint32),
                                      np.asarray(s_xfin))


@pytest.mark.parametrize("n,l1", [(20, 130), (384, 130), (256, 129),
                                  (64, 2)])
def test_staged_lane_table_round_trips(n, l1):
    rng = np.random.default_rng(n + l1)
    table = torch.from_numpy(rng.integers(0, 65537, size=(n, l1),
                                          dtype=np.int32))
    staged = cuda_rans.stage_lane_table(table)
    npad = -(-n // 32) * 32
    assert staged.shape == (l1 * npad,) and staged.dtype == torch.int32
    grid = staged.view(l1, npad)
    assert torch.equal(grid[:, :n].t(), table)
    assert not grid[:, n:].any()


@pytest.mark.parametrize("r,l1", [(64, 257), (1, 130), (5, 129), (3, 2)])
def test_staged_ctx_table_round_trips(r, l1):
    rng = np.random.default_rng(r * l1)
    table = torch.from_numpy(rng.integers(0, 65537, size=(r, l1),
                                          dtype=np.int32))
    staged = cuda_rans.stage_ctx_table(table)
    pitch = l1 | 1
    assert pitch % 2 == 1 and staged.numel() % 4 == 0
    assert staged.numel() == -(-r * pitch // 4) * 4
    rows = staged[: r * pitch].view(r, pitch)
    assert torch.equal(rows[:, :l1], table)
    assert not rows[:, l1:].any() and not staged[r * pitch:].any()


def test_instance_is_chosen_by_shape():
    """The path shapes stage their table; N = 1024 lanes of 130 entries,
    and a 256-row table of 257, search it in global memory."""
    paths = {(384, 130, None): 204032,     # int8 latent, C
             (256, 129, None): 134400,     # hyper z, C
             (384, 257, 64): 70144}        # hyper y, E
    for (n, l1, r), nbytes in paths.items():
        assert cuda_rans.decode_staged_fits(n, l1, r)
        ring = 1 << (3 * (-(-n // 32) * 32) - 1).bit_length()
        assert 4 * cuda_rans._staged_ints(n, l1, r) + 2 * ring + 256 == \
            nbytes
    assert not cuda_rans.decode_staged_fits(1024, 130)
    assert not cuda_rans.decode_staged_fits(384, 257, 256)
    assert cuda_rans.decode_staged_fits(20, 130)
    assert cuda_rans.decode_staged_fits(1024, 2, 64)


def test_kernel_table_cache_follows_the_tensor():
    """Made once per table tensor; rebuilt after an in-place write and for
    a new tensor of the same shape; the table itself where the global
    instance runs."""
    rng = np.random.default_rng(3)

    def fresh():
        return torch.from_numpy(rng.integers(0, 65537, size=(64, 130),
                                             dtype=np.int32))
    a = fresh()
    first = cuda_rans.kernel_table(a, 64, False)
    assert cuda_rans.kernel_table(a, 64, False) is first
    assert torch.equal(first.view(130, 64).t(), a)
    a.add_(1)
    again = cuda_rans.kernel_table(a, 64, False)
    assert again is not first and torch.equal(again.view(130, 64).t(), a)
    ctx_rows = cuda_rans.kernel_table(a, 64, True)      # as an E table
    assert torch.equal(ctx_rows[: 64 * 131].view(64, 131)[:, :130], a)
    for _ in range(8):         # new tensors, ids and storage reused
        del a, first, again, ctx_rows
        gc.collect()
        a = fresh()
        first = cuda_rans.kernel_table(a, 64, False)
        again = cuda_rans.kernel_table(a, 64, False)
        ctx_rows = cuda_rans.kernel_table(a, 64, True)
        assert torch.equal(first.view(130, 64).t(), a)
    big = torch.zeros((1024, 130), dtype=torch.int32)
    assert cuda_rans.kernel_table(big, 1024, False) is big


def test_int_codec_lane_table_is_uploaded_once():
    rng = np.random.default_rng(5)
    cdfs = _rand_rows(rng, 4, 128)
    t1 = int_codec._lane_cdf_tensor(cdfs, 8, "cpu")
    assert int_codec._lane_cdf_tensor(cdfs.copy(), 8, "cpu") is t1
    np.testing.assert_array_equal(t1.numpy(), cdfs[np.arange(8) % 4])
    other = cdfs.copy()
    other[0, 1] += 1
    t2 = int_codec._lane_cdf_tensor(other, 8, "cpu")
    assert t2 is not t1
    np.testing.assert_array_equal(t2.numpy(), other[np.arange(8) % 4])
    assert int_codec._lane_cdf_tensor(other, 12, "cpu").shape == (12, 129)


def test_private_launchers_run_the_plain_version_on_cpu():
    lane_cdf, syms, words, counts, t, _ = _lane_case("n20")
    x0 = cuda_rans.split_init(words, 20)
    runs = cuda_rans.decode.plain_runs
    got = cuda_rans._decode(words, x0, torch.from_numpy(lane_cdf), t)
    assert cuda_rans.decode.plain_runs == runs + 1
    np.testing.assert_array_equal(got[0].numpy(), syms)
    table, ctx, syms, words, counts, t, _ = _ctx_case("r1")
    x0 = cuda_rans.split_init(words, ctx.shape[2])
    runs = cuda_rans.decode_ctx.plain_runs
    got = cuda_rans._decode_ctx(words, x0, torch.from_numpy(table),
                                torch.from_numpy(ctx), t)
    assert cuda_rans.decode_ctx.plain_runs == runs + 1
    np.testing.assert_array_equal(got[0].numpy(), syms)
    assert cuda_rans.decode.launches == 0 and \
        cuda_rans.decode_ctx.launches == 0
