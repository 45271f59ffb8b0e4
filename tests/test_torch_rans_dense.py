"""Kernel H (the dense-flag encode, csrc/rans_encode.cu): its division by a
magic number, a plain model of the kernel's whole loop as it reads its
layouts, the wrapper's CPU path, and its grid and instance, against plain
integer division and the JAX package.

Each step of kernel H divides by a precomputed magic number
(Granlund-Montgomery's round-up method); ``cuda_rans.dense_quotient`` and
``dense_step`` are its integer steps in int64 PyTorch ops.  They are held
to ``//`` and ``%`` for every divisor in 1..2^16 at the dividends where such
a division breaks, and on seeded random ones.  ``_kernel_model`` runs the
kernel's loop as the card does: blocks of lanes by streams, the ragged
ones masked, start, freq and the magic number from the packed layout (or
the int32 table and the magic layout); it equals the plain encoder, which
equals the JAX package's encoders (the Pallas kernel in interpret mode past
1,024 lanes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu.codec import device_rans as j_dev
from simple_image_compression_network_tpu.codec import entropy as j_ent
from simple_image_compression_network_tpu.codec import pallas_rans
from simple_image_compression_network_tpu_torch.codec import cuda_rans

torch.set_num_threads(1)

FREQS = torch.arange(1, 65537, dtype=torch.int64)
U32 = 2 ** 32


def _dividends(freq: torch.Tensor, n_random: int, seed: int):
    """(y (F, K), valid (F, K)): per divisor the dividends where a division
    by it breaks (0, 1, around freq, 2^16, freq * 2^16 - freq and the top
    of the range) and ``n_random`` seeded ones, valid where y < min(freq *
    2^16, 2^32), the range of an encode step's y."""
    f = freq[:, None]
    top = torch.clamp(f << 16, max=U32)
    fixed = torch.cat([
        torch.zeros_like(f), torch.ones_like(f), f - 1, f, f + 1,
        torch.full_like(f, 65535), torch.full_like(f, 65536),
        torch.full_like(f, 65537), (f << 16) - f - 1, (f << 16) - f,
        (f << 16) - f + 1, top - 2, top - 1], 1)
    gen = torch.Generator().manual_seed(seed)
    rand = (torch.rand((len(freq), n_random), generator=gen,
                       dtype=torch.float64) * top).to(torch.int64)
    y = torch.cat([fixed, rand], 1)
    return y, (y >= 0) & (y < top)


def test_quotient_is_exact_for_every_freq():
    """hi32(y * m) + y >> l == y // freq for every freq in 1..2^16 at its
    breaking dividends and 16 random ones; m below 2^32, l = ceil(log2
    freq)."""
    m, l = cuda_rans.dense_magic(FREQS), cuda_rans.dense_shift(FREQS)
    assert int(m.min()) >= 1 and int(m.max()) < U32
    assert int(l[0]) == 0 and int(l[-1]) == 16
    assert torch.equal(l[1:], torch.ceil(torch.log2(
        FREQS[1:].double())).to(torch.int64))
    y, valid = _dividends(FREQS, 16, 0)
    q = cuda_rans.dense_quotient(y.clamp(min=0), m[:, None], l[:, None])
    f = FREQS[:, None].expand_as(y)
    assert torch.equal(q[valid], (y // f)[valid])
    assert int(valid.sum()) > 65536 * 20


def test_quotient_is_exact_for_wide_divisors():
    """The global instance divides by whatever a row gives: seeded
    divisors up to 2^32 - 1 (and the powers of two) over dividends up to
    2^32 - 1."""
    gen = torch.Generator().manual_seed(1)
    d = torch.cat([(torch.rand(20000, generator=gen, dtype=torch.float64)
                    * (U32 - 65536)).to(torch.int64) + 65536,
                   torch.tensor([2 ** k for k in range(32)]),
                   torch.tensor([U32 - 1, 3, 7, 641, 6700417])])
    y = torch.cat([(torch.rand((len(d), 8), generator=gen,
                               dtype=torch.float64) * U32).to(torch.int64),
                   torch.full((len(d), 1), U32 - 1), d[:, None] - 1,
                   d[:, None], (d[:, None] * 2).clamp(max=U32 - 1)], 1)
    q = cuda_rans.dense_quotient(y, cuda_rans.dense_magic(d)[:, None],
                                 cuda_rans.dense_shift(d)[:, None])
    assert torch.equal(q, y // d[:, None])


@pytest.mark.parametrize("part", range(4))
def test_step_equals_the_recurrence(part):
    """``dense_step`` (threshold compare, select, magic quotient, one
    multiply-add) == the plain step (x >> 16) >= freq, then ((y // freq)
    << 16) + y % freq + start, for states in [2^16, 2^32) at the renorm
    edges and at random, every freq of this quarter of 1..2^16, a start
    that keeps the row inside 2^16."""
    freq = FREQS[part::4]
    f = freq[:, None]
    edge = torch.clamp(f << 16, max=U32 - 1)
    gen = torch.Generator().manual_seed(10 + part)
    x = torch.cat([torch.full_like(f, 65536), edge - 1, edge,
                   (edge + 1).clamp(max=U32 - 1), torch.full_like(f, U32 - 1),
                   65536 + (torch.rand((len(freq), 8), generator=gen,
                                       dtype=torch.float64)
                            * (U32 - 65536)).to(torch.int64)], 1)
    start = ((torch.rand((len(freq), 1), generator=gen, dtype=torch.float64)
              * (65537 - f)).to(torch.int64)).expand_as(x)
    f = f.expand_as(x)
    word, need, new = cuda_rans.dense_step(
        x, start, f, cuda_rans.dense_magic(f))
    ref_need = (x >> 16) >= f
    y = torch.where(ref_need, x >> 16, x)
    assert torch.equal(need, ref_need)
    assert torch.equal(word, x & 0xFFFF)
    assert torch.equal(new, ((y // f) << 16) + y % f + start)
    assert bool(((new >= 65536) & (new < U32)).all())


def _rand_rows(rng, rows: int, n_sym: int) -> np.ndarray:
    return np.stack([j_ent.quantize_cdf(rng.dirichlet(np.ones(n_sym) * 0.3))
                     for _ in range(rows)]).astype(np.int32)


def _draw(rng, table: np.ndarray, s: int, t: int) -> np.ndarray:
    """(S, t, N) symbols drawn from each lane's row."""
    u = rng.integers(0, 65536, size=(s, t, table.shape[0]))
    return (table[None, None, :, 1:-1] <= u[..., None]).sum(-1)


def _kernel_model(syms: torch.Tensor, lane_cdf: torch.Tensor,
                  n_sms: int = 132):
    """Kernel H's loop as the card runs it: blocks of ``DENSE_LANES``
    lanes by the streams ``dense_plan`` gives a card of ``n_sms`` SMs
    (lanes past N and streams past S masked), each thread reading its
    lane's column of the layouts
    ``encode_dense_table`` makes (the packed entries: start, 2^16 - freq
    and the magic number; or the int32 row and the magic layout);
    ``dense_step`` a step.  Returns the plain encoder's (emits, needs,
    x_fin) in its types, and the plan."""
    s, t_steps, n = syms.shape
    l1 = lane_cdf.shape[1]
    layout, magic, mode = cuda_rans.encode_dense_table(lane_cdf)
    plan = cuda_rans.dense_plan(s, n, l1, mode == cuda_rans.ENC_STAGED,
                                n_sms)
    assert plan.mode == mode
    npad = -(-n // 32) * 32
    if mode == cuda_rans.ENC_STAGED:   # (nblk, L, lanes) -> (L, lanes)
        word = layout.transpose(0, 1).reshape(l1 - 1, -1)
        start, c = word & 0xFFFF, (word >> 16) & 0xFFFF
        freq, mag = 65536 - c, (word >> 32) & 0xFFFFFFFF
    else:
        cdf = torch.zeros((l1, npad), dtype=torch.int64)
        cdf[:, :n] = lane_cdf.to(torch.int64).t()
        start, freq = cdf[:-1], (cdf[1:] - cdf[:-1]) & 0xFFFFFFFF
        mag = magic.to(torch.int64).reshape(l1 - 1, npad) & 0xFFFFFFFF
    emits = torch.zeros((s, t_steps, n), dtype=torch.int32)
    needs = torch.zeros((s, t_steps, n), dtype=torch.bool)
    x_fin = torch.zeros((s, n), dtype=torch.int32)
    lanes = cuda_rans.DENSE_LANES
    nblk = -(-n // lanes)
    assert plan.blocks == -(-s // plan.streams) * nblk
    for b in range(plan.blocks):
        g, c0 = b // nblk, (b % nblk) * lanes
        k = torch.arange(c0, c0 + lanes).repeat(plan.streams)
        si = (g * plan.streams + torch.arange(plan.streams)).repeat_interleave(
            lanes)
        active = (k < n) & (si < s)
        kr, sr = torch.where(k < n, k, 0), si.clamp(max=s - 1)
        x = torch.full(k.shape, 65536, dtype=torch.int64)
        for t in range(t_steps - 1, -1, -1):
            sym = syms[sr, t, kr].to(torch.int64).clamp(0, l1 - 2)
            word, need, x = cuda_rans.dense_step(
                x, start[sym, kr], freq[sym, kr], mag[sym, kr])
            emits[si[active], t, k[active]] = word[active].to(torch.int32)
            needs[si[active], t, k[active]] = need[active]
        x_fin[si[active], k[active]] = (x[active] - (x[active] >= 2 ** 31).to(
            torch.int64) * U32).to(torch.int32)
    return (emits, needs, x_fin), plan


CASES = {  # name: (S, t, N, table kind)
    "ragged": (3, 20, 200, "rand"),
    "n1100": (2, 8, 1100, "rand"),
    "one_lane": (2, 9, 1, "rand"),
    "short_last": (2, 12, 70, "last_short"),
    "stream_rows": (5, 10, 70, "rand"),      # 4 streams a block at 8 SMs
}


def _case(name):
    s, t, n, kind = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    table = _rand_rows(rng, n, 128)
    syms = _draw(rng, table, s, t)
    if kind == "last_short":     # no u16 layout: the global instance
        table[:, -1] = 65535
        syms = np.minimum(syms, 126)
    return (torch.from_numpy(np.ascontiguousarray(syms, np.int8)),
            torch.from_numpy(table))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_equals_the_plain_encoder(name):
    """The model of the kernel's loop (blocks of lanes by streams,
    layouts, magic division) == the plain encoder, the wrapper's CPU
    path, on int8 and int32 symbols alike; its final states are the JAX
    package's scan encoder's header."""
    syms, table = _case(name)
    n_sms = 8 if name == "stream_rows" else 132
    got, plan = _kernel_model(syms, table, n_sms)
    assert plan.streams == cuda_rans.dense_streams(*syms.shape[::2], n_sms)
    assert name != "stream_rows" or plan.streams == 4
    runs = cuda_rans.encode_dense.plain_runs
    ref8 = cuda_rans.encode_dense(syms, table)
    ref32 = cuda_rans.encode_dense(syms.to(torch.int32), table)
    assert cuda_rans.encode_dense.plain_runs == runs + 2
    assert cuda_rans.encode_dense.launches == 0
    for g, r8, r32 in zip(got, ref8, ref32):
        assert g.dtype == r8.dtype == r32.dtype
        assert torch.equal(r8, r32)
        assert torch.equal(g, r8)
    j_words, _ = j_dev.encode(jnp.asarray(syms[0].numpy().astype(np.int32)),
                              jnp.asarray(table.numpy()), None)
    n = syms.shape[2]
    head = np.asarray(j_words)[:2 * n].astype(np.int64)
    np.testing.assert_array_equal(
        ref8[2][0].numpy().view(np.uint32), (head[0::2] << 16) | head[1::2])
    want = cuda_rans.ENC_GLOBAL if name == "short_last" else \
        cuda_rans.ENC_STAGED
    assert plan.mode == want


def test_n_above_1024_matches_the_pallas_kernel():
    """S = 2, t = 8, N = 1,100 (past one block's thread limit, which the
    first kernel H refused): ``encode_batch`` on int8 and int32 symbols ==
    the JAX package's ``encode_batch`` (its Pallas kernel in interpret
    mode), words over the whole width and counts."""
    syms, table = _case("n1100")
    p_words, p_counts = pallas_rans.encode_batch(
        jnp.asarray(syms.numpy().astype(np.int32)),
        jnp.asarray(table.numpy()), interpret=True)
    for sy in (syms, syms.to(torch.int32)):
        words, counts = cuda_rans.encode_batch(sy, table)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(p_counts))
        np.testing.assert_array_equal(words.numpy(), np.asarray(p_words))


@pytest.mark.parametrize("s,n,n_sms,streams,blocks", [
    (16, 384, 132, 4, 4 * 12), (16, 384, 96, 8, 2 * 12),
    (3, 200, 132, 1, 3 * 7), (2, 1100, 132, 2, 35),
    (256, 384, 132, 8, 32 * 12), (5, 20, 4, 4, 2), (1, 1, 132, 1, 1)])
def test_grid_covers_lanes_and_streams(s, n, n_sms, streams, blocks):
    """ceil(S / streams) * ceil(N / 32) blocks for any N and S, the last
    lane block and stream row ragged, the streams a block following the
    card's SM count; the staged instance at the latent's rows (L+1 = 130:
    33,024 bytes)."""
    plan = cuda_rans.dense_plan(s, n, 130, True, n_sms)
    assert plan == cuda_rans.DensePlan(blocks, streams, 8 * 129 * 32,
                                       cuda_rans.ENC_STAGED)
    nblk = -(-n // 32)
    assert (nblk - 1) * 32 < n <= nblk * 32
    assert blocks // nblk * streams >= s > (blocks // nblk - 1) * streams


@pytest.mark.parametrize("s,streams", [(1, 1), (2, 1), (5, 2), (16, 4),
                                       (32, 8), (256, 8), (4096, 8)])
def test_streams_a_block_leave_a_block_for_every_4_sms(s, streams):
    """The rows of a block share its staged slab: as many streams a block
    (1, 2, 4, 8) as leave at least a block for every 4 of the card's SMs;
    the int8 latent (N = 384, 12 lane blocks of 32) on an H100 SXM's 132
    SMs at B = 2 (S = 16) runs 4 streams a block, at B = 32 (S = 256)
    eight."""
    plan = cuda_rans.dense_plan(s, 384, 130, True, 132)
    assert cuda_rans.dense_streams(s, 384, 132) == streams
    assert plan.streams == streams
    assert streams == 1 or plan.blocks * 4 >= 132
    assert cuda_rans.dense_streams(16, 384, 114) == 4    # H100 PCIe
    assert cuda_rans.dense_streams(16, 384, 96) == 8     # fewer SMs
    assert cuda_rans.dense_streams(16, 20, 132) == 1     # 16 blocks in all
    assert cuda_rans.dense_streams(2, 1100, 132) == 2    # no empty rows


def test_default_plan_and_its_limits():
    """Blocks of ``DENSE_LANES`` lanes, a slab of 8-byte entries each;
    rows too long for a block's slab in shared memory beside the
    mbarrier, or a table without a packed layout, run the global
    instance."""
    plan = cuda_rans.dense_plan(16, 384, 130, True, 132)
    assert cuda_rans.DENSE_LANES == 32
    assert plan == cuda_rans.DensePlan(16 // plan.streams * 12, plan.streams,
                                       cuda_rans.dense_table_bytes(130),
                                       cuda_rans.ENC_STAGED)
    assert cuda_rans.dense_table_bytes(130) == 33024
    assert cuda_rans.dense_plan(16, 384, 130, False, 132) == plan._replace(
        smem=0, mode=cuda_rans.ENC_GLOBAL)
    # 908 rows of 32 entries fill SMEM_LIMIT; the mbarrier's 16 bytes
    # leave no room for them
    assert 8 * 908 * 32 == cuda_rans.SMEM_LIMIT
    assert cuda_rans.dense_slab_fits(908)
    assert not cuda_rans.dense_slab_fits(909)
    assert cuda_rans.dense_plan(2, 64, 908, True, 132).mode == \
        cuda_rans.ENC_STAGED
    assert cuda_rans.dense_plan(2, 64, 909, True, 132) == \
        cuda_rans.DensePlan(4, 1, 0, cuda_rans.ENC_GLOBAL)


@pytest.mark.parametrize("n", [40, 70])
def test_packed_layout_holds_start_freq_and_magic(n):
    """(ceil(N / 32), L, 32): symbol j of lane 32 c + x at [c, j, x], start
    in bits 0-15, 2^16 - freq in 16-31, freq's magic number in 32-63; freq
    exact for every symbol of freq >= 1 wherever 2^16 lies in the row (the
    u16 rule); lanes past N zero."""
    rng = np.random.default_rng(4)
    table = _rand_rows(rng, n, 128)
    table[::3, 100:] = 65536          # zero-frequency symbols at the end
    packed = cuda_rans.stage_lane_packed(torch.from_numpy(table))
    nblk = -(-n // 32)
    assert packed.shape == (nblk, 128, 32)
    grid = packed.transpose(0, 1).reshape(128, nblk * 32)
    assert not bool(grid[:, n:].any())
    word = grid[:, :n].t()
    true_freq = np.diff(table.astype(np.int64), axis=1)
    codable = true_freq > 0
    np.testing.assert_array_equal((word & 0xFFFF).numpy()[codable],
                                  table[:, :-1][codable])
    freq = 65536 - ((word >> 16) & 0xFFFF)
    np.testing.assert_array_equal(freq.numpy()[codable], true_freq[codable])
    assert torch.equal((word >> 32) & 0xFFFFFFFF, cuda_rans.dense_magic(freq))


@pytest.mark.parametrize("fault", ["negative", "above_2_16", "last_short"])
def test_tables_outside_u16_take_the_global_instance(fault):
    """A table without a u16 layout: ``encode_dense_table`` hands over the
    int32 table itself with the magic layout, mode global; the magic
    layout is each symbol's freq mod 2^32 in lane-fastest order."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(_rand_rows(rng, 100, 129))
    tb, magic, mode = cuda_rans.encode_dense_table(table)
    assert mode == cuda_rans.ENC_STAGED and tb.dtype == torch.int64
    assert magic is None
    bad = table.clone()
    if fault == "negative":
        bad[3, 0] = -1
    elif fault == "above_2_16":
        bad[5, 100:] = 65537
    else:
        bad[:, -1] = 65535
    tb, magic, mode = cuda_rans.encode_dense_table(bad)
    assert mode == cuda_rans.ENC_GLOBAL and tb is bad
    cuda_rans._check_dense_table((tb, magic, mode), bad)
    grid = magic.numpy().view(np.uint32).reshape(129, 128)
    freq = torch.from_numpy(np.diff(bad.numpy().astype(np.int64), axis=1)
                            & 0xFFFFFFFF)
    np.testing.assert_array_equal(grid[:, :100].T.astype(np.int64),
                                  cuda_rans.dense_magic(freq).numpy())
    assert not grid[:, 100:].any()
    with pytest.raises(ValueError):
        cuda_rans._check_dense_table((tb, magic, cuda_rans.ENC_STAGED), bad)
    assert cuda_rans.stage_lane_packed(bad) is None


def test_dense_layouts_are_cached_and_checked():
    """The packed and magic layouts are made once per table tensor and
    remade after a write; layouts made ahead must fit the table."""
    rng = np.random.default_rng(9)
    table = torch.from_numpy(_rand_rows(rng, 40, 129))
    tb = cuda_rans.encode_dense_table(table)
    assert cuda_rans.encode_dense_table(table)[0] is tb[0]
    cuda_rans._check_dense_table(tb, table)
    for bad in ((tb[0][:-1], None, tb[2]), (tb[0], tb[0], tb[2]),
                (tb[0], None, cuda_rans.ENC_U16),
                (tb[0].view(torch.int32), None, tb[2]),
                (tb[0].reshape(-1), None, tb[2]),
                (cuda_rans.stage_lane_packed(table[:32]), None, tb[2])):
        with pytest.raises(ValueError):
            cuda_rans._check_dense_table(bad, table)
    table[0, 5] += 1
    again = cuda_rans.encode_dense_table(table)
    assert again[0] is not tb[0]
    assert torch.equal(again[0], cuda_rans.stage_lane_packed(table))
    table[0, -1] = 65535               # no packed layout now
    glob = cuda_rans.encode_dense_table(table)
    assert glob[2] == cuda_rans.ENC_GLOBAL and glob[0] is table
    assert cuda_rans.encode_dense_table(table)[1] is glob[1]
    cuda_rans._check_dense_table(glob, table)
    with pytest.raises(ValueError):
        cuda_rans._check_dense_table((table, None, cuda_rans.ENC_GLOBAL),
                                     table)
