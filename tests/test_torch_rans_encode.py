"""Kernels B and D: the placement of their words, their plain versions at
the encoders' edges, and the wrappers' host-side helpers, against the JAX
package.

The card's kernels (csrc/rans_encode.cu) write every step's candidate word
to a slot, record each warp's emit mask with a ballot, scan the (step, warp)
word counts once in step-major, warp order and place each lane's word at
2N + the offset of its (step, warp) + the popcount of the mask below the
lane.  ``place_words`` models that placement in plain PyTorch on the plain
state loop; it and the wrappers' plain versions are held against the JAX
package's lax.scan encoder (and its Pallas kernel in interpret mode at the
small shapes) at lane counts off the warp (N = 20) and past 512 (N = 1024),
a single step, steps where every lane or no lane emits, one context row,
contexts at both ends of the table and 256 rows: words over the whole
width, the zero tail included, and counts.  Then the instance choice by
shape, the u16 table layout (exact for every codable symbol, wherever 2^16
lies in the row) and the tables it cannot hold, the layout cache and the
private launchers."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu.codec import device_rans as j_dev
from simple_image_compression_network_tpu.codec import entropy as j_ent
from simple_image_compression_network_tpu.codec import pallas_rans
from simple_image_compression_network_tpu_torch.codec import cuda_rans
from simple_image_compression_network_tpu_torch.codec import device_rans

torch.set_num_threads(1)


def _popcount(m: torch.Tensor) -> torch.Tensor:
    return sum((m >> i) & 1 for i in range(32))


def place_words(emits: torch.Tensor, needs: torch.Tensor,
                x_fin: torch.Tensor):
    """The kernels' placement: (S, t, N) candidate words and need flags and
    (S, N) final states -> (words (S, 2N + t*N) int64, counts (S,))."""
    s, t, n = emits.shape
    npad = -(-n // 32) * 32
    nw = npad // 32
    need = torch.zeros((s, t, npad), dtype=torch.int64)
    need[..., :n] = needs.to(torch.int64)
    lane = torch.arange(npad) % 32
    warp = torch.arange(npad) // 32
    masks = (need.view(s, t, nw, 32) << torch.arange(32)).sum(-1)
    counts = _popcount(masks).reshape(s, t * nw)
    off = (torch.cumsum(counts, 1) - counts).reshape(s, t, nw)
    mine = masks[:, :, warp]                       # (S, t, npad)
    rank = _popcount(mine & ((1 << lane) - 1))
    pos = 2 * n + off[:, :, warp] + rank
    words = torch.zeros((s, 2 * n + t * n), dtype=torch.int64)
    emit = need.bool()
    rows = torch.arange(s)[:, None, None].expand(s, t, npad)
    cand = torch.zeros((s, t, npad), dtype=torch.int64)
    cand[..., :n] = emits
    words[rows[emit], pos[emit]] = cand[emit]
    words[:, 0:2 * n:2] = x_fin >> 16
    words[:, 1:2 * n:2] = x_fin & 0xFFFF
    return words, 2 * n + counts.sum(1)


def _rand_rows(rng, rows: int, n_sym: int) -> np.ndarray:
    return np.stack([j_ent.quantize_cdf(rng.dirichlet(np.ones(n_sym) * 0.3))
                     for _ in range(rows)]).astype(np.int32)


def _draw(rng, rows: np.ndarray, shape) -> np.ndarray:
    """Symbols drawn from each position's row (rows (..., L+1))."""
    u = rng.integers(0, 65536, size=shape)
    return (rows[..., 1:-1] <= u[..., None]).sum(-1)


def _flat_rows(n: int) -> np.ndarray:
    """Rows of 256 symbols of frequency 256: every lane emits at every
    other step, all lanes at once."""
    return np.tile(np.arange(257, dtype=np.int32) * 256, (n, 1))


def _skewed_rows(n: int) -> np.ndarray:
    """Rows where one symbol has frequency 65535 (symbol 0, or symbol 1
    after a zero-frequency symbol 0), the rest 1 or 0 (interior 65536s):
    coding it, no lane emits for many steps."""
    a = np.concatenate([[0, 65535], np.full(127, 65536)])
    b = np.concatenate([[0, 0, 65535], np.full(126, 65536)])
    return np.stack([a if k % 2 == 0 else b for k in range(n)]).astype(
        np.int32)


CASES = {
    # name: (S, t, N, R for a context table or None, rows)
    "n20": (3, 12, 20, None, "rand"),
    "n1024": (1, 3, 1024, None, "rand"),
    "t1": (2, 1, 48, None, "rand"),
    "all_emit": (2, 10, 64, None, "flat"),
    "no_emit": (2, 12, 40, None, "skewed"),
    "ctx_r1": (2, 10, 37, 1, "rand"),
    "ctx_ends": (2, 8, 64, 64, "rand"),
    "ctx_r256": (1, 4, 384, 256, "rand"),
}
PALLAS = ("n20", "all_emit", "ctx_r1")     # small enough for interpret mode


def _case(name):
    """(symbols (S, t, N) int32, table, contexts or None)."""
    s, t, n, r, kind = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 7)
    if r is not None:
        table = _rand_rows(rng, r, 256)
        ctx = rng.integers(0, r, size=(s, t, n)).astype(np.int32)
        if name == "ctx_ends":
            ctx = np.where(ctx < r // 2, 0, r - 1).astype(np.int32)
        return _draw(rng, table[ctx], (s, t, n)).astype(np.int32), table, ctx
    if kind == "flat":
        table = _flat_rows(n)
        syms = rng.integers(0, 128, size=(s, t, n))
    elif kind == "skewed":
        table = _skewed_rows(n)
        syms = np.broadcast_to(np.arange(n) % 2, (s, t, n))
    else:
        table = _rand_rows(rng, n, 128)
        syms = _draw(rng, np.broadcast_to(table, (s, t, n, 129)), (s, t, n))
    return np.ascontiguousarray(syms, np.int32), table, None


def _jax_words(syms, table, ctx):
    """The JAX package's lax.scan encoder over each stream: (words (S,
    2N + t*N) u32, counts (S,))."""
    jt = jnp.asarray(table)
    if ctx is None:
        w, c = jax.vmap(lambda sy: j_dev.encode(sy, jt, None))(
            jnp.asarray(syms))
    else:
        w, c = jax.vmap(lambda sy, cx: j_dev.encode(sy, jt, cx))(
            jnp.asarray(syms), jnp.asarray(ctx))
    return np.asarray(w).astype(np.int64), np.asarray(c).astype(np.int64)


def _check_emits(name, counts, n, t):
    if name == "all_emit":     # the case does what its name says
        assert (counts == 2 * n + n * (t // 2)).all()
    if name == "no_emit":
        assert (counts == 2 * n).all()


@pytest.mark.parametrize("name", list(CASES))
def test_placement_model_matches_jax(name):
    """Ballots per (step, warp), one step-major scan and popcount ranks
    place the plain state loop's words as the JAX package's encoder does,
    the header and zero tail included."""
    syms, table, ctx = _case(name)
    s, t, n = syms.shape
    emits, needs, x_fin = device_rans.encode_dense(
        torch.from_numpy(syms), torch.from_numpy(table),
        None if ctx is None else torch.from_numpy(ctx))
    words, counts = place_words(emits, needs, x_fin)
    j_words, j_counts = _jax_words(syms, table, ctx)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    np.testing.assert_array_equal(words.numpy(), j_words)
    _check_emits(name, counts.numpy(), n, t)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_encoders_match_jax(name):
    """Kernel B's or D's plain version (the wrapper on CPU tensors) ==
    the JAX package's encoders over the whole width, in the wrapper's
    types; the Pallas kernel in interpret mode over each stream's count."""
    syms, table, ctx = _case(name)
    s, t, n = syms.shape
    if ctx is None:
        runs = cuda_rans.encode_batch_compact.plain_runs
        words, counts = cuda_rans.encode_batch_compact(
            torch.from_numpy(syms.astype(np.int8)), torch.from_numpy(table))
        assert cuda_rans.encode_batch_compact.plain_runs == runs + 1
    else:
        runs = cuda_rans.encode_batch_compact_ctx.plain_runs
        words, counts = cuda_rans.encode_batch_compact_ctx(
            torch.from_numpy(syms), torch.from_numpy(table),
            torch.from_numpy(ctx))
        assert cuda_rans.encode_batch_compact_ctx.plain_runs == runs + 1
    assert words.dtype == torch.int16 and counts.dtype == torch.int32
    assert words.shape == (s, 2 * n + t * n)
    w = words.numpy().view(np.uint16).astype(np.int64)
    j_words, j_counts = _jax_words(syms, table, ctx)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    np.testing.assert_array_equal(w, j_words)
    for j in range(s):                               # the zero tail
        assert not w[j, counts[j]:].any()
    _check_emits(name, counts.numpy(), n, t)
    if name in PALLAS:
        p_words, p_counts = pallas_rans.encode_batch_compact(
            jnp.asarray(syms), jnp.asarray(table),
            None if ctx is None else jnp.asarray(ctx),
            cap_words=t * n + 64, interpret=True)
        p_words, p_counts = np.asarray(p_words), np.asarray(p_counts)
        np.testing.assert_array_equal(counts.numpy(), p_counts.ravel())
        for j in range(s):
            np.testing.assert_array_equal(w[j, :counts[j]],
                                          p_words[j, :counts[j]])


def test_staged_instance_is_chosen_by_shape():
    """The three path shapes stage table, slots and pairs in shared memory
    (B's table as u16); a 3840x2160 frame's stream (t = 2,025 at N = 384)
    and more than 512 lanes run the global instance."""
    paths = {(384, 96, 130, None): 182912,     # int8 latent, B u16
             (256, 48, 129, None): 93824,      # hyper z, B u16
             (384, 96, 257, 64): 148864}       # hyper y, D
    for (n, t, l1, r), nbytes in paths.items():
        assert cuda_rans.encode_staged_fits(n, t, l1, r)
        npad = -(-n // 32) * 32
        table = 2 * l1 * npad if r is None else \
            4 * cuda_rans._staged_ints(n, l1, r)
        assert 128 + table + 2 * t * npad + 8 * t * (npad // 32) == nbytes
        assert cuda_rans.encode_table_bytes(n, l1, r) == table
    assert not cuda_rans.encode_staged_fits(384, 2025, 130)
    assert not cuda_rans.encode_staged_fits(384, 2025, 257, 64)
    assert cuda_rans.encode_slot_bytes(384, 2025) == 1749600
    assert cuda_rans.encode_staged_fits(512, 8, 2)
    assert not cuda_rans.encode_staged_fits(544, 8, 2)


@pytest.mark.parametrize("n,l1", [(20, 130), (384, 130), (256, 129),
                                  (64, 2)])
def test_u16_lane_table_round_trips(n, l1):
    """Entry j of lane k at j * npad + k as u16, lanes past N zero, the
    last entry 2^16 stored as 0."""
    rng = np.random.default_rng(n * l1)
    table = np.sort(rng.integers(0, 65536, size=(n, l1)), axis=1)
    table[:, 0], table[:, -1] = 0, 65536
    staged = cuda_rans.stage_lane_table_u16(torch.from_numpy(
        table.astype(np.int32)))
    npad = -(-n // 32) * 32
    assert staged.dtype == torch.int16 and staged.shape == (l1 * npad,)
    grid = staged.numpy().view(np.uint16).reshape(l1, npad).astype(np.int64)
    np.testing.assert_array_equal(grid[:, :n].T, table & 0xFFFF)
    assert not grid[:, n:].any() and not grid[-1].any()
    # freq = ((end - start - 1) & 0xFFFF) + 1, as the kernel computes it
    freq = ((grid[1:, :n] - grid[:-1, :n] - 1) & 0xFFFF) + 1
    np.testing.assert_array_equal(freq.T, np.diff(table, axis=1) + (
        np.diff(table, axis=1) == 0) * 65536)


def _u16_start_freq(staged: torch.Tensor, n: int, l1: int):
    """(start, freq) (N, L) of every symbol as the kernel reads them from
    the u16 layout."""
    npad = -(-n // 32) * 32
    grid = staged.numpy().view(np.uint16).reshape(l1, npad)[:, :n].T
    grid = grid.astype(np.int64)
    return grid[:, :-1], ((grid[:, 1:] - grid[:, :-1] - 1) & 0xFFFF) + 1


@pytest.mark.parametrize("kind", ["interior", "trailing_zeros", "skewed"])
def test_u16_layout_is_exact_for_every_codable_symbol(kind):
    """Tables with 2^16 before their last entry (zero-frequency symbols
    inside or at the end of the row) stay u16: start and freq are exact
    for every symbol of freq >= 1, and the encoder's words equal the JAX
    package's on a stream that codes them."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "skewed":
        table = _skewed_rows(40)
    else:
        table = _rand_rows(rng, 40, 128)
        if kind == "interior":
            table[::3, 60:70] = 65536 - 7 * (np.arange(40)[::3, None] % 2)
            table[::3, 70:] = 65536
        else:
            table[::2, 100:] = 65536
        table = np.maximum.accumulate(table, axis=1).astype(np.int32)
    n, l1 = table.shape
    tt = torch.from_numpy(table)
    staged = cuda_rans.stage_lane_table_u16(tt)
    assert staged is not None
    assert cuda_rans.encode_kernel_table(tt, n, 48, False)[1] == \
        cuda_rans.ENC_U16
    start, freq = _u16_start_freq(staged, n, l1)
    true_freq = np.diff(table.astype(np.int64), axis=1)
    codable = true_freq > 0
    assert (~codable).any()
    np.testing.assert_array_equal(start[codable], table[:, :-1][codable])
    np.testing.assert_array_equal(freq[codable], true_freq[codable])
    # a stream of codable symbols only, drawn from each lane's row
    syms = _draw(rng, np.broadcast_to(table, (2, 12, n, l1)), (2, 12, n))
    assert codable[np.arange(n), syms].all()
    words, counts = cuda_rans.encode_batch_compact(
        torch.from_numpy(syms.astype(np.int8)), tt)
    j_words, j_counts = _jax_words(syms.astype(np.int32), table, None)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    np.testing.assert_array_equal(
        words.numpy().view(np.uint16).astype(np.int64), j_words)


@pytest.mark.parametrize("fault", ["negative", "above_2_16", "last_short"])
def test_tables_outside_u16_take_the_global_instance(fault):
    """A negative entry, an entry above 2^16 or a last entry other than
    2^16 has no u16 layout: kernel B reads such a table in global
    memory, at every shape."""
    rng = np.random.default_rng(11)
    table = torch.from_numpy(_rand_rows(rng, 384, 129))
    assert cuda_rans.encode_kernel_table(table, 384, 96, False)[1] == \
        cuda_rans.ENC_U16
    bad = table.clone()
    if fault == "negative":
        bad[3, 0] = -1
    elif fault == "above_2_16":
        bad[5, 100:] = 65537
    else:
        bad[:, -1] = 65535
    assert cuda_rans.stage_lane_table_u16(bad) is None
    tb, mode = cuda_rans.encode_kernel_table(bad, 384, 96, False)
    assert mode == cuda_rans.ENC_GLOBAL and tb is bad


def test_encode_table_cache_follows_the_tensor():
    """Made once per table tensor and mode; rebuilt after an in-place write
    and for new tensors; kernel D shares kernel E's row layout; the table
    itself where the global instance runs."""
    rng = np.random.default_rng(13)

    def fresh():
        return torch.from_numpy(_rand_rows(rng, 64, 129))
    a = fresh()
    first, mode = cuda_rans.encode_kernel_table(a, 64, 20, False)
    assert mode == cuda_rans.ENC_U16
    assert cuda_rans.encode_kernel_table(a, 64, 20, False)[0] is first
    a[0, 1] += 1
    again = cuda_rans.encode_kernel_table(a, 64, 20, False)[0]
    assert again is not first
    assert torch.equal(again, cuda_rans.stage_lane_table_u16(a))
    rows, mode = cuda_rans.encode_kernel_table(a, 64, 20, True)
    assert mode == cuda_rans.ENC_STAGED
    assert cuda_rans.kernel_table(a, 64, True) is rows
    for _ in range(8):          # new tensors, ids and storage reused
        del a, first, again, rows
        gc.collect()
        a = fresh()
        first = cuda_rans.encode_kernel_table(a, 64, 20, False)[0]
        again = cuda_rans.encode_kernel_table(a, 64, 20, False)[0]
        rows = cuda_rans.encode_kernel_table(a, 64, 20, True)[0]
        assert again is first
        assert torch.equal(first, cuda_rans.stage_lane_table_u16(a))
        assert torch.equal(rows, cuda_rans.stage_ctx_table(a))
    tb, mode = cuda_rans.encode_kernel_table(a, 64, 5000, False)
    assert mode == cuda_rans.ENC_GLOBAL and tb is a


def test_encode_layout_and_outputs_made_ahead_are_checked():
    """A layout made ahead must be one that the shape may run, of its
    mode's shape and type; the outputs must fit the call.  Only the global
    instance has a scratch, of ``encode_slot_bytes`` a stream."""
    table = torch.from_numpy(_rand_rows(np.random.default_rng(17), 64, 129))
    u16 = cuda_rans.encode_kernel_table(table, 64, 20, False)
    cuda_rans._check_encode_table(u16, table, 64, 20, False)
    for bad in ((u16[0], cuda_rans.ENC_STAGED),
                (cuda_rans.stage_lane_table(table), cuda_rans.ENC_U16),
                (u16[0], cuda_rans.ENC_U16 + 5),
                (table, cuda_rans.ENC_U16)):
        with pytest.raises(ValueError):
            cuda_rans._check_encode_table(bad, table, 64, 20, False)
    with pytest.raises(ValueError):     # u16 where the shape runs global
        cuda_rans._check_encode_table(u16, table, 64, 5000, False)
    cuda_rans._check_encode_table((table, cuda_rans.ENC_GLOBAL), table, 64,
                                  5000, False)
    dev = torch.device("cpu")
    out = cuda_rans._encode_outputs(3, 20, 64, cuda_rans.ENC_U16, dev)
    assert out[0].shape == (3, 2 * 64 + 20 * 64) and out[2] is None
    cuda_rans._check_encode_outputs(out, 3, 20, 64, cuda_rans.ENC_U16, dev)
    with pytest.raises(ValueError):
        cuda_rans._check_encode_outputs(out, 3, 20, 64, cuda_rans.ENC_GLOBAL,
                                        dev)
    out = cuda_rans._encode_outputs(3, 20, 64, cuda_rans.ENC_GLOBAL, dev)
    assert out[2].numel() == 3 * cuda_rans.encode_slot_bytes(64, 20)
    cuda_rans._check_encode_outputs(out, 3, 20, 64, cuda_rans.ENC_GLOBAL,
                                    dev)


def test_private_encoders_run_the_plain_version_on_cpu():
    syms, table, _ = _case("n20")
    ref = cuda_rans.encode_batch_compact(
        torch.from_numpy(syms.astype(np.int8)), torch.from_numpy(table))
    runs = cuda_rans.encode_batch_compact.plain_runs
    got = cuda_rans._encode(torch.from_numpy(syms.astype(np.int8)),
                            torch.from_numpy(table))
    assert cuda_rans.encode_batch_compact.plain_runs == runs + 1
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    syms, table, ctx = _case("ctx_r1")
    runs = cuda_rans.encode_batch_compact_ctx.plain_runs
    got = cuda_rans._encode_ctx(torch.from_numpy(syms),
                                torch.from_numpy(table),
                                torch.from_numpy(ctx))
    assert cuda_rans.encode_batch_compact_ctx.plain_runs == runs + 1
    j_words, j_counts = _jax_words(syms, table, ctx)
    np.testing.assert_array_equal(got[1].numpy(), j_counts)
    syms, table, _ = _case("t1")
    runs = cuda_rans.encode_dense.plain_runs
    emits, needs, x_fin = cuda_rans._encode_dense(torch.from_numpy(syms),
                                                  torch.from_numpy(table))
    assert cuda_rans.encode_dense.plain_runs == runs + 1
    assert emits.dtype == x_fin.dtype == torch.int32
    assert cuda_rans.encode_batch_compact.launches == 0
    assert cuda_rans.encode_batch_compact_ctx.launches == 0
    assert cuda_rans.encode_dense.launches == 0
