"""Spatially sharded (mean-)scale-hyperprior codec on ``torch.distributed``
ranks.

The counterpart of the JAX package's ``parallel/hyper_sharded.py``.  The
image's X axis is cut over a 1-D rank mesh (``mesh.py``); each rank is a
process holding its tile (SPMD), and every rank makes the same collectives
in the same order:

* the float transforms g_a, h_a and g_s run on the tiles, each conv on its
  tile extended by the halo rows its receptive field needs, exchanged with
  the neighbouring ranks (``spatial.halo_exchange_grad``, whose backward
  carries the halos' gradients back, so that ``train_loop --sp`` trains
  through the same layers; JAX's GSPMD inserts these exchanges itself).  GDN, IGDN, ReLU, ``abs`` and ``round`` act on
  a tile as they are;
* the prior: the rounded z_hat tiles are all-gathered (small: N x zx x zy
  an image) and every rank runs the wrapped codec's own ``_prior_from_z``
  on the whole z_hat, then keeps its rows of the scale bins (and mu);
* the entropy stage: each rank codes the spatial streams of its own latent
  tile, z on kernel B and y on kernel D, and decodes them on kernels C and
  E, the calls the single-device codec makes (``codec/cuda_rans.py``; on
  the CPU their plain versions run).  With S = n * s_local streams a
  tensor, rank k owns streams [k * s_local, (k + 1) * s_local): contiguous
  latent rows, the single-device stream split, so the containers are the
  single-device device format.

Escapes (values outside the device alphabets) are not coded here: a batch
whose all-reduced escape count is nonzero is re-encoded by the wrapped
codec on every rank, and a container with raw sections is decoded by it,
as in the JAX package.  A geometry whose stream plan does not tile over
the ranks raises ValueError, as the JAX package asserts; there is no
fallback for it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..codec import cuda_rans, device_rans, escape, hyper_codec, ilrans
from ..codec.int_codec import _upload_streams
from ..models.hyperprior import _Deconv
from . import spatial
from .entropy_sharded import _all_gather
from .mesh import Mesh


def conv_tile(layer, h: torch.Tensor, mesh: Mesh, axis: str = "x"
              ) -> torch.Tensor:
    """A ``_Conv`` (k, stride s, pad p) on this rank's rows of an NCHW
    activation cut on X (dim 2) over ``mesh``: output rows [a, b) read
    input rows s*a - p .. s*(b - 1) - p + k - 1, so the tile [s*a, s*b)
    takes p rows from below and k - s - p from above ((2, 1) for k5/s2,
    (1, 1) for k3/s1), then the layer's weight and bias run with no pad on
    X and its own on Y.  The tile's rows must be a multiple of s."""
    k, s, p = layer.kernel_size[0], layer.stride[0], layer.padding[0]
    hx = spatial.halo_exchange_grad(h, (p, k - s - p), mesh, axis, 2)
    return layer.conv(hx, (0, layer.padding[1]))


def deconv_tile(layer: _Deconv, h: torch.Tensor, mesh: Mesh,
                axis: str = "x") -> torch.Tensor:
    """A ``_Deconv`` (flax's k5/s2 SAME transposed conv) on this rank's
    rows, as ``conv_tile``: output rows [2a, 2b) read input rows a - 1 ..
    b, a halo of 1 on each side.  The layer's own forward on the extended
    tile (input rows a - 1 .. b) gives output rows 2a - 2 .. 2b + 1; the
    first and last two are cut.  The layer keeps its own pads, so cuDNN
    sees the whole image's convolution on fewer rows."""
    hx = spatial.halo_exchange_grad(h, 1, mesh, axis, 2)
    return layer(hx)[..., 2:-2, :]


def _tiled(mesh: Mesh, axis: str):
    """The transforms' ``conv`` hook: each layer on this rank's tile."""
    def conv(layer, h: torch.Tensor) -> torch.Tensor:
        tile = deconv_tile if isinstance(layer, _Deconv) else conv_tile
        return tile(layer, h, mesh, axis)
    return conv


def analysis_local(model, x_tile: torch.Tensor, mesh: Mesh,
                   axis: str = "x") -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (B, X/n, Y, 3) image tile -> its (unrounded y, rounded
    z_hat) tiles, NHWC float32: g_a, then h_a on |y|, as
    ``analysis_arrays`` (its ``_exact_float`` flags), each conv tiled."""
    return model.analysis_arrays(x_tile, conv=_tiled(mesh, axis))


def synthesis_local(model, y_hat_tile: torch.Tensor, mesh: Mesh,
                    axis: str = "x") -> torch.Tensor:
    """This rank's y_hat tile -> its x_hat tile: g_s as ``decode_arrays``,
    each transposed conv tiled."""
    return model.decode_arrays(y_hat_tile, conv=_tiled(mesh, axis))


class ShardedHyperCodec:
    """Spatially sharded serving wrapper around a port ``HyperCodec`` or
    ``MeanScaleCodec``: it shares the codec's model, tables and table
    cache.

    SPMD: every rank calls ``compress_batch`` with the same global images
    and gets the same ``CODEC_HYPERPRIOR_DEV`` containers; every rank calls
    ``decompress_batch`` with the same containers and gets its own
    (x_hat, y_hat) tiles, X cut over the mesh (``spatial.gather_image``
    assembles them).  Where escapes send a batch to the wrapped codec,
    every rank holds its whole result.  ``routes`` counts the calls by
    route ("sharded", "fallback")."""

    def __init__(self, codec, mesh: Mesh, axis_name: str = "x"):
        if mesh.axis_names != (axis_name,):
            raise ValueError(f"ShardedHyperCodec tiles X over a 1-D mesh "
                             f"named {axis_name!r}, not {mesh.axis_names}")
        if codec.device != mesh.device:
            raise ValueError(f"the model lies on {codec.device}, the mesh's "
                             f"rank on {mesh.device}")
        self.codec = codec
        self.mesh = mesh
        self.axis = axis_name
        self.n = mesh.size(axis_name)
        self.routes = {"sharded": 0, "fallback": 0}

    def _plans(self, zx: int, zy: int, zc: int, yx: int, yy: int, yc: int
               ) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
        """The single-device stream plans (S, lanes, steps) of z and y.
        Raises ValueError unless each tensor's S and latent rows divide by
        the rank count: then a rank's rows are whole streams."""
        plans = []
        for rows, cols, ch, tag in ((zx, zy, zc, "z"), (yx, yy, yc, "y")):
            s, n_lanes, t_steps = hyper_codec._plan_lanes(rows * cols, ch)
            if s % self.n or rows % self.n:
                raise ValueError(f"{tag} stream plan S={s}, rows={rows} "
                                 f"does not tile over {self.n} ranks")
            plans.append((s, n_lanes, t_steps))
        return plans[0], plans[1]

    def _prior_ctx(self, z_tile: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """This rank's z_hat tile -> this rank's rows of (scale bins, mu or
        None).

        The tiles are all-gathered (as int16 bytes) and every rank runs the
        wrapped codec's ``_prior_from_z`` on the whole z_hat: h_s image by
        image, the single-device codec's own call on the same values.  JAX
        runs h_s under GSPMD on the tiles instead; here a tile's float conv
        may sum in another order than the whole image's (cuDNN picks its
        algorithm by shape), and one ulp of sigma on a scale-bin edge would
        move a bin.  The gathered z_hat gives sigma and mu bitwise equal to
        the single-device codec's, so the two codecs' containers decode
        under each other.  Values beyond int16 are escapes of z, whose
        batches go to the wrapped codec."""
        z_hat = spatial.gather_image(z_tile.to(torch.int16), self.mesh,
                                     (self.axis,)).to(torch.float32)
        mu, sigma = self.codec._prior_from_z(z_hat)
        rows = sigma.shape[1] // self.n
        mine = slice(self.mesh.coord(self.axis) * rows,
                     (self.mesh.coord(self.axis) + 1) * rows)
        ctx = self.codec._scale_ctx(sigma[:, mine])
        return ctx, None if mu is None else mu[:, mine]

    # -- per-rank entropy stage ------------------------------------------
    def _encode_tiled(self, z: torch.Tensor, y: torch.Tensor,
                      ctx: torch.Tensor, plans) -> Tuple:
        """This rank's integer z and y tiles -> (z words (B*s_local, cap),
        z counts, y words, y counts): z on kernel B with the lane table, y
        on kernel D with its scale bins."""
        (s_z, nl_z, t_z), (s_y, nl_y, t_y) = plans
        b = z.shape[0]
        zs = escape.to_symbols(z, hyper_codec._Z_MAX).to(torch.int8)
        zw, zcnt = cuda_rans.encode_batch_compact(
            zs.reshape(b * s_z // self.n, t_z, nl_z),
            self.codec._z_lane_cdf(nl_z))
        ys = escape.to_symbols(y, hyper_codec._Y_MAX_DEV)
        yw, ycnt = cuda_rans.encode_batch_compact(
            ys.reshape(b * s_y // self.n, t_y, nl_y), self.codec._y_table(),
            ctx=ctx.reshape(b * s_y // self.n, t_y, nl_y).contiguous())
        return zw, zcnt, yw, ycnt

    def _decode_tiled(self, words: torch.Tensor, counts: torch.Tensor,
                      ctx: Optional[torch.Tensor], n_lanes: int,
                      t_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's streams -> (symbols, ok a stream): kernel C on the
        lane table, or kernel E on the scale bins ``ctx``.  A stream is ok
        iff it consumed its word count and every lane ends at 2^16."""
        x0 = cuda_rans.split_init(words, n_lanes)
        if ctx is None:
            syms, consumed, x_fin = cuda_rans.decode(
                words, x0, self.codec._z_lane_cdf(n_lanes), t_steps)
        else:
            syms, consumed, x_fin = cuda_rans.decode_ctx(
                words, x0, self.codec._y_table(),
                ctx.reshape(words.shape[0], t_steps, n_lanes).contiguous(),
                t_steps)
        ok = (consumed == counts) & (x_fin == ilrans.STATE_LB).all(1)
        return syms.to(torch.int32), ok

    # -- public API ------------------------------------------------------
    def compress_batch(self, x: torch.Tensor) -> List[bytes]:
        """The global (B, X, Y, 3) images in [0, 1], the same on every rank
        -> B containers, the same on every rank."""
        b, xd, yd, _ = x.shape
        if xd % 64 or yd % 64:
            raise ValueError("hyperprior codecs need image sides divisible "
                             "by 64 (16x analysis, 4x hyper stage)")
        model = self.codec.model
        zx, zy, yx, yy = xd // 64, yd // 64, xd // 16, yd // 16
        plans = self._plans(zx, zy, model.n, yx, yy, model.m)
        (s_z, nl_z, t_z), (s_y, nl_y, t_y) = plans
        y, z_hat = analysis_local(model, spatial.shard_image(x, self.mesh),
                                  self.mesh, self.axis)
        ctx, mu = self._prior_ctx(z_hat)
        # half to even, as the single-device codec and jnp.round
        y = torch.round(y if mu is None else y - mu).to(torch.int32)
        z = z_hat.to(torch.int32)
        zw, zcnt, yw, ycnt = self._encode_tiled(z, y, ctx, plans)
        esc = torch.stack([(z.abs() > hyper_codec._Z_MAX).sum(),
                           (y.abs() > hyper_codec._Y_MAX_DEV).sum()])
        esc = esc.to(self.mesh.comm_device)
        dist.all_reduce(esc)
        if int(esc.sum()):
            # the raw side sections are the wrapped codec's: it re-encodes
            # the batch, the same bytes on every rank
            self.routes["fallback"] += 1
            return self.codec.compress_batch(x)
        self.routes["sharded"] += 1
        # stream j of an image lives on rank j // s_local
        counts = _all_gather(torch.cat([zcnt, ycnt]), self.mesh)
        nz = s_z // self.n
        zcnt_np = counts[:, :b * nz].reshape(self.n, b, nz).transpose(
            1, 0, 2).reshape(b * s_z)
        ycnt_np = counts[:, b * nz:].reshape(self.n, b, -1).transpose(
            1, 0, 2).reshape(b * s_y)
        mz = min(device_rans.bucket_words(int(zcnt_np.max())), zw.shape[1])
        my = min(device_rans.bucket_words(int(ycnt_np.max())), yw.shape[1])
        words = _all_gather(torch.cat([zw[:, :mz].reshape(-1),
                                       yw[:, :my].reshape(-1)]), self.mesh)
        words = words.view(np.uint16)
        n_wz = zw.shape[0] * mz
        zw_np = words[:, :n_wz].reshape(self.n, b, nz, mz).transpose(
            1, 0, 2, 3).reshape(b * s_z, mz)
        yw_np = words[:, n_wz:].reshape(self.n, b, -1, my).transpose(
            1, 0, 2, 3).reshape(b * s_y, my)
        z_chunks = device_rans.streams_from_words(zw_np, zcnt_np,
                                                  t_z * nl_z, nl_z)
        y_chunks = device_rans.streams_from_words(yw_np, ycnt_np,
                                                  t_y * nl_y, nl_y)
        geometry = (xd, yd, zx, zy, model.n, yx, yy, model.m)
        return [hyper_codec.pack_dev(geometry,
                                     z_chunks[i * s_z:(i + 1) * s_z],
                                     y_chunks[i * s_y:(i + 1) * s_y])
                for i in range(b)]

    def decompress_batch(self, blobs: Sequence[bytes]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same B containers on every rank -> this rank's (x_hat (B,
        X/n, Y, 3), y_hat (B, yx/n, yy, M)) tiles, float32 NHWC.  Raises
        ValueError on every rank when any rank finds a corrupt stream."""
        metas = hyper_codec.parse_dev(blobs)
        if any(escape.unpack_raw(m[3])[0].size
               or escape.unpack_raw(m[4])[0].size for m in metas):
            # containers with escapes (the wrapped codec's encode): its
            # decoder, the whole result on every rank
            self.routes["fallback"] += 1
            return self.codec.decompress_batch(blobs)
        (_, _, zx, zy, zc, yx, yy, yc) = metas[0][0]
        (s_z, nl_z, t_z), (s_y, nl_y, t_y) = self._plans(zx, zy, zc, yx, yy,
                                                         yc)
        if any(len(m[1]) != s_z or len(m[2]) != s_y for m in metas):
            raise ValueError("stream plan does not match the geometry")
        self.routes["sharded"] += 1
        b, k = len(blobs), self.mesh.coord(self.axis)
        nz, ny = s_z // self.n, s_y // self.n
        dev = self.mesh.device
        # only this rank's streams go to its device
        zw, zcnt = _upload_streams(
            [ch for m in metas for ch in m[1][k * nz:(k + 1) * nz]], dev)
        yw, ycnt = _upload_streams(
            [ch for m in metas for ch in m[2][k * ny:(k + 1) * ny]], dev)
        z_syms, z_ok = self._decode_tiled(zw, zcnt, None, nl_z, t_z)
        z = z_syms.reshape(b, zx // self.n, zy, zc) - hyper_codec._Z_MAX
        ctx, mu = self._prior_ctx(z)
        y_syms, y_ok = self._decode_tiled(yw, ycnt, ctx, nl_y, t_y)
        y_hat = (y_syms.reshape(b, yx // self.n, yy, yc)
                 - hyper_codec._Y_MAX_DEV).to(torch.float32)
        if mu is not None:
            y_hat = y_hat + mu
        x_hat = synthesis_local(self.codec.model, y_hat, self.mesh,
                                self.axis)
        flags = torch.stack([z_ok.all(), y_ok.all()]).to(torch.int32)
        flags = flags.to(self.mesh.comm_device)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        if not int(flags[0]):
            raise ValueError("corrupt hyper-latent stream")
        if not int(flags[1]):
            raise ValueError("corrupt latent stream")
        return x_hat, y_hat
