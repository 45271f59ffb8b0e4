"""The Python side of the port's tensor-core conv tile (``csrc/conv_taps.cuh``,
kernels A and F): the K-major weight packing, the merge of thin output
blocks, the im2col K of thin input blocks and the wrapper's tile choice.

A plain GEMM over the packed layout (``packed_gemm``: what the kernel
computes from it, one GEMM per tap entry or per im2col row, in int64) is
held against the JAX package's Pallas kernels (interpret mode, as
``tests/test_torch_plans.py`` runs them) and against the port's plain
versions.  Every comparison is exact (integers)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simple_image_compression_network_tpu.ops import pallas_conv
from simple_image_compression_network_tpu_torch.models import codec_int
from simple_image_compression_network_tpu_torch.ops import conv_fast
from simple_image_compression_network_tpu_torch.ops import cuda_conv

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..",
                   "simple_image_compression_network_tpu_torch", "csrc",
                   "conv_taps.cuh")
SMS = 132   # streaming multiprocessors of an H100 SXM


def _int8(rng, shape, lo=-128, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, size=shape, dtype=np.int8))


def packed_gemm(x, pk, bias, relu=True, x_valid=False, y_valid=False):
    """The tile's function over a ``TapPack``: per output block, one GEMM
    per table entry against its K-major slice, or one GEMM of the im2col
    rows against the block's slice; int64 sums, then the wrap epilogue."""
    b, xd, yd, _ = x.shape
    px, py = (0 if x_valid else 1), (0 if y_valid else 1)
    xo, yo = xd - 2 * (1 - px), yd - 2 * (1 - py)
    xp = F.pad(x.to(torch.int64), (0, 0, py, py, px, px))
    w = pk.w.to(torch.int64)
    kw = w.shape[2]
    acc = torch.zeros((b, xo, yo, pk.n_blocks, pk.bn), dtype=torch.int64)

    def window(row, col, cblk):
        return xp[:, row:row + xo, col:col + yo,
                  cblk * pk.kb:(cblk + 1) * pk.kb]
    for o in range(pk.n_blocks):
        entries = [e for e in pk.taps if e[3] == o]
        if pk.im2col:
            a = torch.cat([window(*e[:3]) for e in entries], -1)
            acc[..., o, :] = F.pad(a, (0, kw - a.shape[-1])) @ w[o].T
        else:
            for row, col, cblk, _, widx in entries:
                a = F.pad(window(row, col, cblk), (0, kw - pk.kb))
                acc[..., o, :] += a @ w[widx].T
    acc = acc.reshape(b, xo, yo, -1) + bias.to(torch.int64)
    out = ((acc + 128) & 0xFF) - 128
    return (out.clamp_min(0) if relu else out).to(torch.int8)


def _a_pack(w3):
    c, n = w3.shape[2:]
    return cuda_conv.TapPack(cuda_conv.pack_conv3x3(w3), cuda_conv.DENSE_TAPS,
                             c, n, 1, c < cuda_conv.IM2COL_BELOW)


@pytest.mark.parametrize("c,n", [(12, 20), (40, 48), (64, 8)])
def test_pack_conv3x3_is_k_major_and_zero_padded(rng, c, n):
    w3 = _int8(rng, (3, 3, c, n), -8, 8)
    wp = cuda_conv.pack_conv3x3(w3)
    k = 9 * c if c < cuda_conv.IM2COL_BELOW else c
    kw = -(-k // 32) * 32
    assert wp.dtype == torch.int8 and wp.is_contiguous()
    if c < cuda_conv.IM2COL_BELOW:      # one im2col row: k = tap*C + c
        assert wp.shape == (1, n, kw)
        ref = w3.reshape(9 * c, n).T
        assert torch.equal(wp[0, :, :k], ref)
    else:                               # one (N, K) slice per tap
        assert wp.shape == (9, n, kw)
        for t in range(9):
            assert torch.equal(wp[t, :, :c], w3[t // 3, t % 3].T)
    assert not wp[..., k:].any()


def test_pack_taps_merges_thin_output_blocks(rng):
    """L7's deconv (4 phases of 3 channels): one block of 12 columns over
    the 9 tap positions, each phase's columns zero where it has no tap."""
    w = _int8(rng, (3, 5, 5, 16), 1, 8)              # no zero weight
    taps, wt = cuda_conv.deconv_taps_d2s(w)
    pk = cuda_conv.pack_taps(wt, taps, 4, 16)
    assert (pk.n_blocks, pk.bn, pk.kb, pk.im2col) == (1, 12, 16, True)
    assert sorted(e[:3] for e in pk.taps) == [(r, c, 0) for r in range(3)
                                              for c in range(3)]
    # im2col over the 9 positions: k = position*16 + c, 144 -> 160 bytes
    assert pk.w.shape == (1, 12, 160)
    live = pk.w[0, :, :144].reshape(4, 3, 9, 16).ne(0).all(-1).all(1)
    assert live.sum(1).tolist() == [9, 6, 6, 4]
    wide = cuda_conv.pack_taps(_int8(rng, (25, 40, 3)), taps, 4, 40)
    assert (wide.bn, wide.im2col, tuple(wide.w.shape)) == (12, False,
                                                           (9, 12, 64))


def test_pack_taps_im2col_for_thin_input_blocks(rng):
    """L0's conv on the s2d input (4 phase blocks of 3 channels): one K of
    the 25 entries x 3 channels, 75 -> 96 bytes, in table order."""
    w = _int8(rng, (20, 5, 5, 3), -8, 8)
    taps, wt = cuda_conv.conv_taps_s2d(w)
    pk = cuda_conv.pack_taps(wt, taps, 1, 12)
    assert pk.im2col and pk.w.shape == (1, 20, 96)
    for j, (_, _, _, _, widx) in enumerate(taps):
        assert torch.equal(pk.w[0, :, 3 * j:3 * j + 3], wt[widx].T)
    assert not pk.w[..., 75:].any()
    # a wide input keeps one slice per entry, padded to 32 bytes
    pk = cuda_conv.pack_taps(wt, taps, 1, 80)
    assert not pk.im2col and pk.w.shape == (25, 20, 32)


@pytest.mark.parametrize("c,n,x_valid,y_valid", [
    (12, 16, False, False), (12, 16, True, False), (12, 16, False, True),
    (12, 16, True, True), (40, 48, False, False), (40, 48, True, True)])
def test_packed_conv3x3_matches_pallas(rng, c, n, x_valid, y_valid):
    """Kernel A's packed GEMM (im2col at C = 12, a K padded 40 -> 64 and
    N = 48 otherwise) == the JAX package's 3x3 kernel and the plain
    version, SAME and the three halo modes; Y = 9: off the 16-column
    tile."""
    x = _int8(rng, (2, 18 if x_valid else 16, 9, c))
    w3 = _int8(rng, (3, 3, c, n), -8, 8)
    b = _int8(rng, (n,))
    got = packed_gemm(x, _a_pack(w3), b, x_valid=x_valid, y_valid=y_valid)
    ref = pallas_conv.conv3x3_s1_int8(
        jnp.asarray(x.numpy()), jnp.asarray(w3.numpy()),
        jnp.asarray(b.numpy()), x_valid=x_valid, y_valid=y_valid,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    plain = cuda_conv.conv3x3_s1_int8_plain(x, w3, b, x_valid=x_valid,
                                            y_valid=y_valid)
    assert torch.equal(got, plain)


def _layer(rng, kind, shape, o):
    """A pallas3 layer's kernel-F operands: (x in the layer's layout, w,
    b, s2d/phase input, taps, w_taps, bias, blocks)."""
    x = _int8(rng, shape, -128 if kind == "conv" else 0)
    w = _int8(rng, (o, 5, 5, shape[3]), -8, 8)
    b = _int8(rng, (o,))
    if kind == "conv":
        taps, wt = cuda_conv.conv_taps_s2d(w)
        return x, w, b, conv_fast.space_to_depth(x), taps, wt, b, 1
    taps, wt = cuda_conv.deconv_taps_d2s(w)
    return x, w, b, x, taps, wt, conv_fast.tile_bias(b, 4), 4


@pytest.mark.parametrize("kind,shape,o", [
    ("conv", (1, 16, 16, 128), 128),   # the sparse kernel itself
    ("conv", (1, 16, 12, 3), 16),      # kb = 3: im2col (JAX falls back)
    ("deconv", (1, 8, 6, 32), 3),      # bn = 3: merged (JAX falls back)
])
def test_packed_sparse_matches_pallas3(rng, kind, shape, o):
    """Kernel F's packed GEMM == the JAX package's pallas3 layer (interpret
    mode) and the plain version."""
    x, w, b, xf, taps, wt, bf, nb = _layer(rng, kind, shape, o)
    pk = cuda_conv.pack_taps(wt, taps, nb, xf.shape[3])
    got = packed_gemm(xf, pk, bf)
    assert torch.equal(got, cuda_conv.conv_sparse_int8_plain(xf, wt, bf, taps,
                                                             nb))
    if kind == "deconv":
        got = conv_fast.depth_to_space(got)
    ref = getattr(pallas_conv, f"{kind}2d_int8_pallas3")(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind,shape,o,valid", [
    ("conv", (3, 18, 26, 3), 20, (False, False)),
    ("conv", (1, 14, 30, 40), 70, (True, False)),
    ("deconv", (1, 9, 13, 40), 3, (False, False)),
    ("deconv", (3, 7, 9, 5), 3, (True, True)),
    ("deconv", (3, 5, 17, 48), 10, (False, True)),
])
def test_packed_sparse_edges_match_plain(rng, kind, shape, o, valid):
    """Kernel F's packed GEMM at the smoke run's edge layers (im2col,
    merged blocks, kb off 32, the halo modes) == the plain version."""
    _, _, _, xf, taps, wt, bf, nb = _layer(rng, kind, shape, o)
    pk = cuda_conv.pack_taps(wt, taps, nb, xf.shape[3])
    xv, yv = valid
    assert torch.equal(
        packed_gemm(xf, pk, bf, x_valid=xv, y_valid=yv),
        cuda_conv.conv_sparse_int8_plain(xf, wt, bf, taps, nb, x_valid=xv,
                                         y_valid=yv))


@pytest.mark.parametrize("kind,shape,o", [
    ("conv", (1, 8, 8, 3), 16),      # im2col over the s2d taps
    ("conv", (1, 8, 8, 40), 70),     # kb = 160: one slice per entry
    ("deconv", (1, 4, 4, 40), 3),    # merged blocks
    ("deconv", (1, 4, 4, 5), 3),     # merged blocks as one im2col K
    ("deconv", (1, 4, 4, 48), 10),   # four blocks of 10
])
def test_packed_shape_is_what_pack_taps_makes(rng, kind, shape, o):
    """The shape the prepacked entry of kernel F checks a pack against."""
    _, _, _, xf, taps, wt, _, nb = _layer(rng, kind, shape, o)
    c = xf.shape[3]
    plan = cuda_conv._plan(cuda_conv.as_table(taps), *wt.shape, nb, c)
    assert cuda_conv._packed_shape(plan, *wt.shape[:2]) == tuple(
        cuda_conv.pack_taps(wt, taps, nb, c).w.shape)


@pytest.mark.parametrize("c,n", [(12, 16), (40, 48)])
def test_packed_shape_of_kernel_a(rng, c, n):
    plan = cuda_conv._plan(cuda_conv.DENSE_TAPS, 9, c, n, 1, c)
    assert cuda_conv._packed_shape(plan, 9, c) == tuple(
        cuda_conv.pack_conv3x3(_int8(rng, (3, 3, c, n))).shape)


def test_prepacked_sparse_entry_runs_the_plain_version_on_the_cpu(rng):
    _, _, _, xf, taps, wt, bf, nb = _layer(rng, "deconv", (1, 5, 7, 8), 3)
    pk = cuda_conv.pack_taps(wt, taps, nb, 8)
    runs = cuda_conv.conv_sparse_int8.plain_runs
    got = cuda_conv._conv_sparse(xf, wt, bf, taps, nb, True, False, False, pk)
    assert cuda_conv.conv_sparse_int8.plain_runs == runs + 1
    assert torch.equal(got, cuda_conv.conv_sparse_int8_plain(xf, wt, bf, taps,
                                                             nb))


def test_merge_gives_repeated_entries_positions_of_their_own(rng):
    """Two entries at one position and block stay two GEMMs: summing their
    int8 weights could leave int8."""
    taps = ((1, 1, 0, 0, 0), (1, 1, 0, 0, 1), (0, 2, 0, 1, 2),
            (1, 1, 0, 1, 3))
    wt = _int8(rng, (4, 8, 2), 100, 128)
    x = _int8(rng, (1, 5, 7, 8))
    b = _int8(rng, (4,))
    pk = cuda_conv.pack_taps(wt, taps, 2, 8)
    assert pk.n_blocks == 1 and len(pk.taps) == 3
    assert torch.equal(packed_gemm(x, pk, b, relu=False),
                       cuda_conv.conv_sparse_int8_plain(x, wt, b, taps, 2,
                                                        relu=False))


def test_tiles_match_the_kernel_source():
    with open(SRC) as f:
        text = f.read()

    def array(name):
        body = re.search(name + r"\[kNumTiles\] = \{([^}]*)\}", text)[1]
        return [int(v) for v in body.split(",")]
    assert list(zip(array("kTileM"), array("kTileN"))) == list(
        cuda_conv.TILES)


def _blocks(tile, b, xo, yo, n, nb):
    bm, bn = cuda_conv.TILES[tile]
    return b * -(-xo // (bm // 16)) * -(-yo // 16) * nb * -(-n // bn)


@pytest.mark.parametrize("form,grid,n,want", [
    ("L0", (384, 256), 128, (128, 128)), ("L1", (192, 128), 128, (128, 128)),
    ("L2", (96, 64), 128, (128, 64)), ("L3", (48, 32), 192, (64, 64)),
    ("L4", (48, 32), 512, (128, 64)), ("L5", (96, 64), 512, (128, 128)),
    ("L6", (192, 128), 512, (128, 128)), ("L7", (192, 128), 48, (256, 48)),
])
def test_tile_choice_fills_the_card(form, grid, n, want):
    """Kernel A's default forms at B = 2, 768x512: the largest tile whose
    grid fills the 132 SMs; the 48x32 layers (L3, L4) get smaller tiles."""
    tile = cuda_conv.pick_tile(2, *grid, n, 1, SMS)
    assert cuda_conv.TILES[tile] == want
    assert _blocks(tile, 2, *grid, n, 1) >= SMS


def test_tile_choice_for_thin_and_small_layers():
    # kernel F at L7: the 4 phases of 3 merged into one block of 12
    assert cuda_conv.TILES[cuda_conv.pick_tile(2, 384, 256, 12, 1, SMS)] == \
        (256, 16)
    # too small to fill the card: the tile with the most blocks
    tile = cuda_conv.pick_tile(1, 9, 13, 200, 1, SMS)
    assert cuda_conv.TILES[tile] == (64, 64)
    assert cuda_conv.TILES[cuda_conv.pick_tile(1, 48, 96, 192, 1, SMS)] == \
        (64, 128)


def test_int_codec_net_keeps_packed_weights(rng):
    """The serving module packs its eight forms once (non-persistent
    buffers: the state dict is unchanged)."""
    ci = [3, 4, 4, 4, 6, 4, 4, 4]
    co = [4, 4, 4, 6, 4, 4, 4, 3]
    params = {f"w{i}": _int8(rng, (co[i], 5, 5, ci[i]), -8, 8)
              for i in range(8)}
    params.update({f"b{i}": _int8(rng, (co[i],)) for i in range(8)})
    net = codec_int.IntCodecNet(params, device="cpu")
    for i in range(8):
        assert torch.equal(getattr(net, f"wp_{i}"),
                           cuda_conv.pack_conv3x3(getattr(net, f"w3_{i}")))
        assert f"wp_{i}" not in net.state_dict()
