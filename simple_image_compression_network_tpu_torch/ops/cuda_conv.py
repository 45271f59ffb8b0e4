"""The int8 conv kernels of the port and the layer entry points on them.

The counterpart of the JAX package's ``ops/pallas_conv.py``.  Two kernels,
each with a plain PyTorch version and launch counters on its wrapper:

* kernel A (``csrc/conv3x3_int8.cu``): the fused 3x3/stride-1 int8 conv,
  ``conv3x3_s1_int8`` (also ``conv3x3_s1_int8_any``).  It stands for both
  TPU kernels of that contract, ``_conv3x3_kernel`` (lane layout) and
  ``_flat_kernel`` (flat-M layout): the layouts were the TPU's, and on the
  card both are one NHWC kernel.  SAME padding, or VALID on an axis whose
  input carries the 1-pixel halo (``x_valid``/``y_valid``);
* kernel F (``csrc/conv_sparse_int8.cu``): the block-sparse tap conv,
  ``conv_sparse_int8``, the counterpart of ``_sparse_kernel``.  It runs only
  the 25 real (tap, phase-block) products of a 5x5/s2 layer's s2d or d2s
  rewrite, which kernel A runs densely as 36.

Both kernels run on one tensor-core tile (``csrc/conv_taps.cuh``).  On the
card the wrappers pack the weights K-major with ``pack_taps`` (a permute and
a zero pad, plus one gather for the thin cases) and choose the block tile
with ``pick_tile``, both from the shapes alone: input blocks under 32
channels run as one im2col K, output blocks under 8 channels are merged
into one block over the union of their tap positions, and small layers get
smaller tiles so that a launch fills the card's SMs.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs the plain version.  The layer entry points keep their JAX names and
the JAX parameter layout ([O, 5, 5, I] int8 weights, (O,) int8 bias), and
rewrite the weights per call, as the JAX package does:

* ``conv2d_int8_pallas`` / ``deconv2d_int8_pallas`` (TPU ``_conv3x3_kernel``)
  and ``conv2d_int8_pallas2`` / ``deconv2d_int8_pallas2`` (TPU
  ``_flat_kernel``): the s2d / d2s forms on kernel A.  The RGB output
  layer's 4*3 = 12 phase channels need no padding to 128 on the card;
* ``conv2d_int8_pallas3`` / ``deconv2d_int8_pallas3``: kernel F, with the
  halo modes of the spatially sharded net.  The JAX versions fall back to
  the dense kernels when ``ci % 128``, ``o % 128`` or ``xo % 8`` is not 0:
  those are TPU lane and tile constraints.  The port routes by plan name
  only, so every layer of the ``pallas3`` plan runs on kernel F, the RGB
  layers included; the results are bit-identical either way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from . import conv_fast
from .conv_int import conv_acc_hwio, phase_taps, to_wire_int8, wrap_to_int8

# |acc| <= 9 * C * 128 * 128 must stay below 2^31 in the kernel's int32.
_MAX_C = (1 << 31) // (9 * 128 * 128) - 1
_MAX_TAPS = 32   # tap table entries per launch of kernel F (conv_taps.cuh)
# Block tiles (output pixels, output channels), in the order of kTileM /
# kTileN in csrc/conv_taps.cuh: the kernels take the index.
TILES = ((128, 128), (128, 64), (128, 48), (256, 16), (64, 128), (64, 64),
         (256, 48))
_TILE_Y = 16       # output columns of a block tile (one m16 fragment)
_K_ALIGN = 32      # packed rows are zero-padded to the mma's K of 32 bytes
IM2COL_BELOW = 32  # input blocks narrower than this run as one im2col K,
IM2COL_MAX_C = 64  # where the input has at most this many channels
MERGE_BELOW = 8    # output blocks narrower than this are merged into one
# kernel A's dense table: (row, col, cblk, oblk, widx), widx = row*3 + col
DENSE_TAPS = tuple((t // 3, t % 3, 0, 0, t) for t in range(9))


class TapPack(NamedTuple):
    """Weights packed for the tile: ``w`` (slices, bn, kw) int8 K-major,
    kw a multiple of 32; the table, blocks and mode the kernel runs."""
    w: torch.Tensor
    taps: tuple
    kb: int
    bn: int
    n_blocks: int
    im2col: bool


@functools.lru_cache(maxsize=64)
def _index(rows: tuple, device: torch.device) -> torch.Tensor:
    """A gather index on the device, made once per table: a copy from
    pageable host memory would wait for the stream on every call."""
    return torch.tensor(rows, dtype=torch.int64, device=device)


def as_table(taps) -> tuple:
    """A tap table as a tuple of 5-tuples of ints (hashable)."""
    return tuple(tuple(int(v) for v in e) for e in taps)


class _Plan(NamedTuple):
    merge: tuple      # gather rows (position x block) of the merge, or ()
    im2col: tuple     # gather rows (block x entry) of im2col, or ()
    taps: tuple
    bn: int
    n_blocks: int
    is_im2col: bool
    table: object     # the table as a ctypes int array (5 per entry)


@functools.lru_cache(maxsize=64)
def _plan(taps: tuple, n_taps: int, kb: int, bn: int, n_blocks: int,
          c: int) -> _Plan:
    """What ``pack_taps`` does to a table, worked out once per table.

    Merge (bn < ``MERGE_BELOW``, several blocks): one output block of
    n_blocks*bn columns over the distinct tap positions (row, col, cblk);
    position p's slice holds, in columns [o*bn, (o+1)*bn), block o's
    entry at p or zeros (index n_taps: the zero slice).  An entry repeated
    at one position and block takes a position of its own."""
    merge = ()
    if bn < MERGE_BELOW and n_blocks > 1:
        slot, sel, seen = {}, [], {}
        for row, col, cblk, oblk, widx in taps:
            dup = seen.get((row, col, cblk, oblk), 0)
            seen[(row, col, cblk, oblk)] = dup + 1
            key = (row, col, cblk, dup)
            if key not in slot:
                slot[key] = len(sel)
                sel.append([n_taps] * n_blocks)
            sel[slot[key]][oblk] = widx
        order = sorted(slot, key=lambda k: k[2])
        merge = tuple(tuple(sel[slot[k]]) for k in order)
        taps = tuple((k[0], k[1], k[2], 0, p) for p, k in enumerate(order))
        n_taps, bn, n_blocks = len(order), bn * n_blocks, 1
    is_im2col = kb < IM2COL_BELOW and c <= IM2COL_MAX_C
    im2col = ()
    if is_im2col:
        per = [[e[4] for e in taps if e[3] == o] for o in range(n_blocks)]
        if per != [list(range(n_taps))]:    # kernel A: the slices in order
            j = max(len(p) for p in per)
            im2col = tuple(tuple(p + [n_taps] * (j - len(p))) for p in per)
    table = (ctypes.c_int * (5 * len(taps)))(*[v for e in taps for v in e])
    return _Plan(merge, im2col, taps, bn, n_blocks, is_im2col, table)


def _gather(w_taps: torch.Tensor, rows: tuple) -> torch.Tensor:
    """w_taps[rows] with row index n_taps reading a zero slice."""
    zero = w_taps.new_zeros((1,) + tuple(w_taps.shape[1:]))
    return torch.cat([w_taps, zero])[_index(rows, w_taps.device)]


def pack_taps(w_taps: torch.Tensor, taps, n_blocks: int,
              c: int) -> TapPack:
    """Pack (T, kb, bn) tap weights for the tile of ``conv_taps.cuh``, for
    an input of ``c`` channels.

    Output blocks under ``MERGE_BELOW`` channels are merged first
    (``_plan``).  Then slice t is w_taps[t].T, (bn, kb); or, for kb <
    ``IM2COL_BELOW`` and c <= ``IM2COL_MAX_C`` (im2col), slice o holds the
    entries of output block o in table order side by side, k = j*kb + c.
    Rows are zero-padded to a multiple of 32 bytes, which is exact."""
    n_taps, kb, bn = w_taps.shape
    plan = _plan(as_table(taps), n_taps, kb, bn, n_blocks, c)
    w = w_taps
    if plan.merge:
        w = (_gather(w, plan.merge).permute(0, 2, 1, 3)
             .reshape(len(plan.merge), kb, plan.bn))
    if plan.is_im2col:
        w = _gather(w, plan.im2col) if plan.im2col else w.unsqueeze(0)
        w = w.permute(0, 3, 1, 2).reshape(plan.n_blocks, plan.bn, -1)
    else:
        w = w.transpose(1, 2)
    pad = -w.shape[2] % _K_ALIGN
    w = (F.pad(w, (0, pad)) if pad else w).contiguous()
    return TapPack(w, plan.taps, kb, plan.bn, plan.n_blocks, plan.is_im2col)


def pack_conv3x3(w3: torch.Tensor) -> torch.Tensor:
    """Kernel A's packed weights: (3, 3, C, N) HWIO -> (9, N, kw), or
    (1, N, kw) with k = (row*3 + col)*C + c when C < ``IM2COL_BELOW``."""
    _, _, c, n = w3.shape
    return pack_taps(w3.reshape(9, c, n), DENSE_TAPS, 1, c).w


def pick_tile(b: int, xo: int, yo: int, n_cols: int, n_blocks: int,
              sms: int) -> int:
    """Index into ``TILES`` for a launch: the widest channel tile that fits
    ``n_cols`` (the channels of one output block), then the largest tile
    whose grid fills ``sms`` SMs, else the one with the most blocks."""
    if n_cols <= 16:
        cands = (3,)
    elif n_cols <= 48:
        cands = (6, 2)
    elif n_cols <= 64:
        cands = (1, 5)
    else:
        cands = (0, 1, 4, 5)
    for i in cands:
        bm, bn = TILES[i]
        blocks = (b * -(-xo // (bm // _TILE_Y)) * -(-yo // _TILE_Y)
                  * n_blocks * -(-n_cols // bn))
        if blocks >= sms:
            return i
    return cands[-1]


def _check_int8_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     what: str) -> None:
    if not (x.dtype == w.dtype == bias.dtype == torch.int8):
        raise TypeError(f"{what} takes int8 x, weights and bias")
    if not (x.device == w.device == bias.device):
        raise ValueError("x, weights and bias must be on one device")


def _cuda_ready(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")


def _call_on(x: torch.Tensor, fn, *args) -> int:
    """fn(*args, stream): a C entry point on x's device, on PyTorch's
    current stream there."""
    dev = x.device
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def _out_extent(n: int, valid: bool) -> int:
    out = n - 2 if valid else n
    if out <= 0:
        raise ValueError(f"extent {n} leaves no output with its halo")
    return out


def _epilogue(acc: torch.Tensor, bias: torch.Tensor, relu: bool
              ) -> torch.Tensor:
    out = wrap_to_int8(acc + bias.to(device=acc.device, dtype=torch.int64))
    return torch.clamp_min(out, 0) if relu else out


def conv3x3_s1_int8_plain(x: torch.Tensor, w3: torch.Tensor,
                          bias: torch.Tensor, relu: bool = True,
                          x_valid: bool = False, y_valid: bool = False
                          ) -> torch.Tensor:
    """Plain version of kernel A: exact accumulator, wrap epilogue,
    MSB-ReLU; no padding on an axis marked valid."""
    px, py = (0 if x_valid else 1), (0 if y_valid else 1)
    return _epilogue(conv_acc_hwio(x, w3, stride=1, pads=(px, px, py, py)),
                     bias, relu)


def conv3x3_s1_int8(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor,
                    relu: bool = True, x_valid: bool = False,
                    y_valid: bool = False) -> torch.Tensor:
    """x (B, X, Y, C) int8, w3 (3, 3, C, N) int8 HWIO, bias (N,) int8 ->
    (B, X, Y, N) int8 = max(wrap(conv + bias), 0) (without the max when
    ``relu`` is False).  With ``x_valid``/``y_valid`` the input already
    carries a 1-pixel halo on that axis and the conv is VALID there: the
    output is 2 shorter.

    CUDA tensors launch kernel A (counted in ``conv3x3_s1_int8.launches``);
    CPU tensors run the plain version (counted in ``.plain_runs``)."""
    return _conv3x3(x, w3, bias, relu, x_valid, y_valid, None)


def _conv3x3(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor,
             relu: bool, x_valid: bool, y_valid: bool, wp) -> torch.Tensor:
    """``conv3x3_s1_int8`` with ``wp``, ``pack_conv3x3(w3)`` made ahead
    (``IntCodecNet`` keeps it), or None to pack here."""
    if x.dim() != 4 or w3.dim() != 4 or bias.dim() != 1:
        raise ValueError("expected x (B,X,Y,C), w3 (3,3,C,N), bias (N,)")
    b, xd, yd, c = x.shape
    n = w3.shape[3]
    if tuple(w3.shape) != (3, 3, c, n) or bias.shape[0] != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w3 {tuple(w3.shape)}, bias {tuple(bias.shape)}")
    _check_int8_conv(x, w3, bias, "conv3x3_s1_int8")
    xo, yo = _out_extent(xd, x_valid), _out_extent(yd, y_valid)
    if x.device.type == "cpu":
        conv3x3_s1_int8.plain_runs += 1
        return conv3x3_s1_int8_plain(x, w3, bias, relu, x_valid, y_valid)
    _cuda_ready("conv3x3_s1_int8", x, w3, bias)
    if c > _MAX_C or b > 65535:
        raise ValueError(f"C={c} or B={b} outside the kernel's range")
    out = torch.empty((b, xo, yo, n), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    if wp is None:
        wp = pack_conv3x3(w3)
    im2col = c < IM2COL_BELOW
    kw = -(-(9 * c if im2col else c) // _K_ALIGN) * _K_ALIGN
    if tuple(wp.shape) != (1 if im2col else 9, n, kw) or \
            wp.dtype != torch.int8 or wp.device != x.device:
        raise ValueError(f"packed weights {tuple(wp.shape)} do not fit "
                         f"C={c}, N={n}")
    tile = pick_tile(b, xo, yo, n, 1, _build.sm_count(x.device.index))
    err = _call_on(x, _build.lib().sicn_conv3x3_s1_int8,
                   x.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), b, xd, yd, c, n, kw, int(im2col), tile,
                   int(relu), int(x_valid), int(y_valid))
    _build.check(err, "conv3x3_s1_int8")
    conv3x3_s1_int8.launches += 1
    return out


conv3x3_s1_int8.launches = 0
conv3x3_s1_int8.plain_runs = 0


def conv3x3_s1_int8_any(x: torch.Tensor, w3: torch.Tensor,
                        bias: torch.Tensor, relu: bool = True,
                        x_valid: bool = False, y_valid: bool = False
                        ) -> torch.Tensor:
    """The JAX package's backend-dispatching 3x3 (Pallas on a TPU, XLA
    elsewhere).  The card has one backend, kernel A: this is
    ``conv3x3_s1_int8``."""
    return conv3x3_s1_int8(x, w3, bias, relu, x_valid, y_valid)


@functools.lru_cache(maxsize=64)
def _check_taps(taps, n_taps: int, kb: int, c: int, n_blocks: int) -> None:
    """A tap table the kernel takes: entries (row, col, cblk, oblk, widx)
    in range, sorted by (oblk, cblk), and an int32-safe accumulator."""
    if not 0 < len(taps) <= _MAX_TAPS:
        raise ValueError(f"{len(taps)} taps: 1..{_MAX_TAPS} supported")
    per_block = [0] * n_blocks
    for e in taps:
        row, col, cblk, oblk, widx = e
        if not (0 <= row <= 2 and 0 <= col <= 2 and 0 <= cblk
                and (cblk + 1) * kb <= c and 0 <= oblk < n_blocks
                and 0 <= widx < n_taps):
            raise ValueError(f"tap {tuple(e)} out of range")
        per_block[oblk] += 1
    keys = [(e[3], e[2]) for e in taps]
    if keys != sorted(keys):
        raise ValueError("taps must be sorted by (output block, input block)")
    if max(per_block) * kb * 128 * 128 >= 1 << 31:
        raise ValueError("accumulator could leave int32")


def conv_sparse_int8_plain(x: torch.Tensor, w_taps: torch.Tensor,
                           bias: torch.Tensor, taps, n_blocks: int,
                           relu: bool = True, x_valid: bool = False,
                           y_valid: bool = False) -> torch.Tensor:
    """Plain version of kernel F: the tap table's GEMMs in float64 (every
    partial sum is an integer far below 2^53, so the result is exact),
    then the wrap epilogue per output block."""
    b, xd, yd, _ = x.shape
    _, kb, bn = w_taps.shape
    xo, yo = _out_extent(xd, x_valid), _out_extent(yd, y_valid)
    px, py = (0 if x_valid else 1), (0 if y_valid else 1)
    xp = F.pad(x.to(torch.float64), (0, 0, py, py, px, px))
    wf = w_taps.to(device=x.device, dtype=torch.float64)
    acc = torch.zeros((b, xo, yo, n_blocks, bn), dtype=torch.float64,
                      device=x.device)
    for row, col, cblk, oblk, widx in taps:
        a = xp[:, row:row + xo, col:col + yo, cblk * kb:(cblk + 1) * kb]
        acc[..., oblk, :] += a @ wf[widx]
    acc = acc.reshape(b, xo, yo, n_blocks * bn).round().to(torch.int64)
    return _epilogue(acc, bias, relu)


def conv_sparse_int8(x: torch.Tensor, w_taps: torch.Tensor,
                     bias: torch.Tensor, taps, n_blocks: int,
                     relu: bool = True, x_valid: bool = False,
                     y_valid: bool = False) -> torch.Tensor:
    """Block-sparse tap conv (kernel F).

    x (B, X, Y, C) int8 NHWC; w_taps (T, kb, bn) int8; bias
    (n_blocks*bn,) int8; taps: entries (row, col, cblk, oblk, widx), sorted
    by (oblk, cblk), each adding to output block oblk the product of the
    input channels [cblk*kb, (cblk+1)*kb) at offset (row, col) of the
    3x3 window with w_taps[widx].  Returns (B, Xo, Yo, n_blocks*bn) int8
    after the wrap/bias/ReLU epilogue; Xo = X (SAME) or X - 2 (``x_valid``:
    the input carries the 1-pixel halo), Yo likewise.

    CUDA tensors launch kernel F (``conv_sparse_int8.launches``); CPU
    tensors run the plain version (``.plain_runs``)."""
    return _conv_sparse(x, w_taps, bias, taps, n_blocks, relu, x_valid,
                        y_valid, None)


def _packed_shape(plan: _Plan, n_taps: int, kb: int) -> tuple:
    """The shape of ``pack_taps(...).w`` for a table whose ``_plan`` is
    ``plan``, for w_taps of shape (n_taps, kb, bn), without packing."""
    rows = len(plan.merge) if plan.merge else n_taps
    if plan.is_im2col:
        k = (len(plan.im2col[0]) if plan.im2col else rows) * kb
        rows = plan.n_blocks
    else:
        k = kb
    return (rows, plan.bn, -(-k // _K_ALIGN) * _K_ALIGN)


def _conv_sparse(x: torch.Tensor, w_taps: torch.Tensor, bias: torch.Tensor,
                 taps, n_blocks: int, relu: bool, x_valid: bool,
                 y_valid: bool, pk) -> torch.Tensor:
    """``conv_sparse_int8`` with ``pk``, ``pack_taps(w_taps, taps,
    n_blocks, C)`` made ahead, or None to pack here."""
    if x.dim() != 4 or w_taps.dim() != 3 or bias.dim() != 1:
        raise ValueError("expected x (B,X,Y,C), w_taps (T,kb,bn), bias (N,)")
    b, xd, yd, c = x.shape
    n_taps, kb, bn = w_taps.shape
    if bias.shape[0] != n_blocks * bn:
        raise ValueError(f"bias has {bias.shape[0]} entries for "
                         f"{n_blocks} blocks of {bn}")
    _check_int8_conv(x, w_taps, bias, "conv_sparse_int8")
    taps = as_table(taps)
    _check_taps(taps, n_taps, kb, c, n_blocks)
    xo, yo = _out_extent(xd, x_valid), _out_extent(yd, y_valid)
    if x.device.type == "cpu":
        conv_sparse_int8.plain_runs += 1
        return conv_sparse_int8_plain(x, w_taps, bias, taps, n_blocks, relu,
                                      x_valid, y_valid)
    _cuda_ready("conv_sparse_int8", x, w_taps, bias)
    if b > 65535:
        raise ValueError(f"B={b} outside the kernel's range")
    out = torch.empty((b, xo, yo, n_blocks * bn), dtype=torch.int8,
                      device=x.device)
    if out.numel() == 0:
        return out
    if pk is None:
        pk = pack_taps(w_taps, taps, n_blocks, c)
    plan = _plan(taps, n_taps, kb, bn, n_blocks, c)
    if (pk.taps != plan.taps or pk.w.dtype != torch.int8
            or pk.w.device != x.device or not pk.w.is_contiguous()
            or tuple(pk.w.shape) != _packed_shape(plan, n_taps, kb)):
        raise ValueError(f"packed weights {tuple(pk.w.shape)} do not fit "
                         f"this tap table")
    table = plan.table
    tile = pick_tile(b, xo, yo, plan.bn, plan.n_blocks,
                     _build.sm_count(x.device.index))
    err = _call_on(x, _build.lib().sicn_conv_sparse_int8,
                   x.data_ptr(), pk.w.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), ctypes.addressof(table), len(pk.taps), b,
                   xd, yd, c, kb, plan.bn, plan.n_blocks, pk.w.shape[0],
                   pk.w.shape[2], int(plan.is_im2col), tile, int(relu),
                   int(x_valid), int(y_valid))
    _build.check(err, "conv_sparse_int8")
    conv_sparse_int8.launches += 1
    return out


conv_sparse_int8.launches = 0
conv_sparse_int8.plain_runs = 0


def conv_taps_s2d(w) -> tuple:
    """[O, 5, 5, I] conv kernel -> (taps, w_taps (25, I, O)): the 25 real
    products over the s2d input's 4 phase blocks (a, b), one output block.
    Tap (mx, my) of block (a, b) is w[:, 2mx+a, 2my+b, :]; the missing
    2mx+a = 5 rows and columns are the zeros kernel A runs."""
    w = conv_fast.as_int8(w)
    taps, mats = [], []
    for a in range(2):
        for bph in range(2):
            for mx in range(3):
                for my in range(3):
                    kx, ky = 2 * mx + a, 2 * my + bph
                    if kx < 5 and ky < 5:
                        taps.append((mx, my, a * 2 + bph, 0, len(mats)))
                        mats.append(w[:, kx, ky, :].T)
    return tuple(taps), torch.stack(mats).contiguous()


def deconv_taps_d2s(w) -> tuple:
    """[O, 5, 5, I] deconv kernel -> (taps, w_taps (25, I, O)): output
    phase (px, py) is block px*2+py and reads input offset
    (d, e) = ((px+kx-2)/2, (py+ky-2)/2) for kx of parity (2-px) mod 2
    (the ``deconv_weights_d2s`` geometry): 9/6/6/4 taps."""
    w = conv_fast.as_int8(w)
    taps, mats = [], []
    for p, phase in enumerate(phase_taps()):
        for d, e, kx, ky in phase:
            taps.append((d + 1, e + 1, 0, p, len(mats)))
            mats.append(w[:, kx, ky, :].T)
    return tuple(taps), torch.stack(mats).contiguous()


def deconv_taps_phases(w) -> list:
    """[O, 5, 5, I] deconv kernel -> per output phase (px*2 + py), its own
    (taps, w_taps (n, I, O)): the phase's 9/6/6/4 entries of
    ``deconv_taps_d2s`` as one output block, for one launch of kernel F
    each (the ``phased`` plan)."""
    w = conv_fast.as_int8(w)
    return [(tuple((d + 1, e + 1, 0, 0, j)
                   for j, (d, e, _, _) in enumerate(phase)),
             torch.stack([w[:, kx, ky, :].T for _, _, kx, ky in phase])
             .contiguous())
            for phase in phase_taps()]


def _even_s2d(x: torch.Tensor) -> torch.Tensor:
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"the s2d form needs even extents, got "
                         f"{tuple(x.shape[1:3])}")
    return conv_fast.space_to_depth(to_wire_int8(x)).contiguous()


def conv2d_int8_pallas3(x: torch.Tensor, w, bias, *, x_valid: bool = False,
                        y_valid: bool = False) -> torch.Tensor:
    """Reference conv2d layer (k5/s2/p2) on kernel F over the s2d input.

    With ``x_valid``/``y_valid`` the input already carries a 2-pixel halo
    on that axis (the sharded net's exchange; 1 pixel of the s2d grid) and
    the conv is VALID there: output extent = (dim - 4) / 2."""
    xs = _even_s2d(x)
    taps, w_taps = conv_taps_s2d(w)
    return conv_sparse_int8(xs, w_taps.to(xs.device),
                            conv_fast.as_int8(bias).to(xs.device), taps, 1,
                            x_valid=x_valid, y_valid=y_valid)


def deconv2d_int8_pallas3(x: torch.Tensor, w, bias, *, x_valid: bool = False,
                          y_valid: bool = False) -> torch.Tensor:
    """Reference deconv522 layer on kernel F (one output block per phase,
    9/6/6/4 taps) + depth-to-space.

    With ``x_valid``/``y_valid`` the input carries a 1-pixel halo on that
    axis: output extent = 2 * (dim - 2)."""
    xi = to_wire_int8(x).contiguous()
    taps, w_taps = deconv_taps_d2s(w)
    y = conv_sparse_int8(xi, w_taps.to(xi.device),
                         conv_fast.tile_bias(bias, 4).to(xi.device), taps, 4,
                         x_valid=x_valid, y_valid=y_valid)
    return conv_fast.depth_to_space(y)


def conv2d_int8_pallas(x: torch.Tensor, w, bias) -> torch.Tensor:
    """Reference conv2d layer via s2d + kernel A (TPU ``_conv3x3_kernel``)."""
    return conv_fast.conv2d_int8_s2d(to_wire_int8(x), w, bias)


def deconv2d_int8_pallas(x: torch.Tensor, w, bias) -> torch.Tensor:
    """Reference deconv522 layer via kernel A + depth-to-space (TPU
    ``_conv3x3_kernel``)."""
    return conv_fast.deconv2d_int8_d2s(to_wire_int8(x), w, bias)


def conv2d_int8_pallas2(x: torch.Tensor, w, bias) -> torch.Tensor:
    """Reference conv2d layer via s2d + kernel A (TPU ``_flat_kernel``)."""
    return conv_fast.conv2d_int8_s2d(to_wire_int8(x), w, bias)


def deconv2d_int8_pallas2(x: torch.Tensor, w, bias) -> torch.Tensor:
    """Reference deconv522 layer via kernel A + depth-to-space (TPU
    ``_flat_kernel``)."""
    return conv_fast.deconv2d_int8_d2s(to_wire_int8(x), w, bias)
