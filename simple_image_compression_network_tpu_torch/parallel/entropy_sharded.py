"""Sharded entropy stage: per-tile latent streams + all-reduced rate
statistics.

The counterpart of the JAX package's ``parallel/entropy_sharded.py``.  The
image's X axis is tiled over a 1-D rank mesh (as in ``spatial``).  Each
rank's latent tile, a contiguous block of (zx*zy, C) pixel rows, is exactly
``s_local`` of the int8 codec's spatial streams (``int_codec`` splits the
latent into S = n_ranks * s_local contiguous row-chunks), so the sharded
encoder emits the streams of the single-device ``int_codec.compress_batch``
with the same (S, lane_mult) byte for byte: the bitstream format is
tiling-invariant.

On the card each rank's streams are coded by kernel B and decoded by kernel
C (``codec/cuda_rans.py``), as the single-device codec codes its own; on the
CPU their plain versions run.  The rate statistics are summed with
``dist.all_reduce`` (JAX's ``psum``); ``ShardedIntCodec`` all-gathers the
words and counts so that every rank packs the same containers, and agrees
on a corrupt stream with an all-reduce, so that every rank raises.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..codec import container, cuda_rans, device_rans, ilrans, int_codec
from ..config import ModelConfig, REFERENCE_NET
from ..models.codec_int import IntCodecNet
from . import spatial
from .mesh import Mesh

_NSYM = 128  # int8 latent support (post-ReLU: 0..127)


def _local_histogram(z: torch.Tensor, n_sym: int = _NSYM) -> torch.Tensor:
    """(..., C) latents with values in [0, n_sym) -> (C, n_sym) int64
    counts: one bincount over channel * n_sym + z."""
    c = z.shape[-1]
    key = (z.reshape(-1, c).to(torch.int64)
           + torch.arange(c, device=z.device) * n_sym)
    return torch.bincount(key.reshape(-1),
                          minlength=c * n_sym).reshape(c, n_sym)


def _all_gather(t: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """Every rank's ``t``, stacked in rank order, on the host."""
    return torch.stack(spatial.all_gather(t, mesh)).cpu().numpy()


def _latent_channels(cfg: ModelConfig) -> int:
    return cfg.layers[len(cfg.analysis) - 1].out_ch


def build_static_cdfs_sharded(params: Dict[str, torch.Tensor],
                              x_tile: torch.Tensor, mesh: Mesh,
                              cfg: ModelConfig = REFERENCE_NET,
                              axis_name: str = "x") -> np.ndarray:
    """Per-channel latent CDF tables from X-tiled sample images.

    Each rank counts its tile's latent symbols; the (C, 128) counts are
    summed with ``dist.all_reduce`` and only they reach the host, where
    they are quantized (``int_codec._cdfs_from_counts``).  Every rank
    returns the same (C, 129) table."""
    z = spatial.analysis_local(params, x_tile.to(mesh.device), cfg, mesh,
                               axis_name, None)
    counts = _local_histogram(z).to(mesh.comm_device)
    dist.all_reduce(counts)
    return int_codec._cdfs_from_counts(counts.cpu().numpy())


def _encode_tile(z: torch.Tensor, lane_cdf: torch.Tensor, s_local: int,
                 t_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A latent tile (B, zx/n, zy, C) -> its streams (kernel B):
    (words (B, s_local, cap) int16, counts (B, s_local) int32)."""
    b = z.shape[0]
    words, counts = cuda_rans.encode_batch_compact(
        z.reshape(b * s_local, t_steps, lane_cdf.shape[0]), lane_cdf)
    return words.reshape(b, s_local, -1), counts.reshape(b, s_local)


def _decode_tile(words: torch.Tensor, true_counts: torch.Tensor,
                 lane_cdf: torch.Tensor, t_steps: int, shape: tuple
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's streams (B, s_local, cap) -> (the int8 latent tile of
    ``shape``, ok (B, s_local)) (kernel C).  A stream is ok iff it
    consumed its word count and every lane ends at 2^16."""
    b, s_local, cap = words.shape
    w = words.reshape(b * s_local, cap)
    syms, consumed, x_fin = cuda_rans.decode(
        w, cuda_rans.split_init(w, lane_cdf.shape[0]), lane_cdf, t_steps)
    ok = ((consumed == true_counts.reshape(-1))
          & (x_fin == ilrans.STATE_LB).all(1))
    return syms.reshape(shape), ok.reshape(b, s_local)


def compress_sharded(params: Dict[str, torch.Tensor], x_tile: torch.Tensor,
                     mesh: Mesh, lane_cdf: torch.Tensor,
                     cfg: ModelConfig = REFERENCE_NET, *,
                     s_local: int = 1, lane_mult: int = 2,
                     axis_name: str = "x"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X-tiled analysis + this rank's entropy encode, on ``mesh.device``.

    x_tile: this rank's (B, X/n, Y, 3) tile; lane_cdf: (N, L+1) int32 on
    the device, N = lane_mult * C.  Returns this rank's (words (B,
    s_local, cap) int16, counts (B, s_local) int32): stream j of an image
    lives on rank j // s_local.  Streams assembled from every rank's are
    those of the single-device ``int_codec.compress_batch`` with S =
    n_ranks * s_local."""
    n = mesh.size(axis_name)
    b, xt, yd, _ = x_tile.shape
    n_pix = (xt * n // 16) * (yd // 16)
    if n_pix % (n * s_local * lane_mult):
        raise ValueError(f"{n_pix} latent pixels do not split into "
                         f"{n * s_local} streams of {lane_mult}-pixel steps")
    if lane_cdf.shape[0] != lane_mult * _latent_channels(cfg):
        raise ValueError(f"lane_cdf has {lane_cdf.shape[0]} lanes for "
                         f"lane_mult {lane_mult}")
    z = spatial.analysis_local(params, x_tile.to(mesh.device), cfg, mesh,
                               axis_name, None)
    return _encode_tile(z, lane_cdf, s_local,
                        n_pix // lane_mult // (n * s_local))


def decompress_sharded(params: Dict[str, torch.Tensor], words: torch.Tensor,
                       true_counts: torch.Tensor, mesh: Mesh,
                       lane_cdf: torch.Tensor, out_shape: Tuple[int, int],
                       cfg: ModelConfig = REFERENCE_NET, *,
                       t_steps: int, axis_name: str = "x"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's entropy decode + X-tiled synthesis, on ``mesh.device``.

    words: this rank's (B, s_local, cap) int16 streams, true_counts (B,
    s_local) int32 (``shard_streams``).  Returns this rank's (x_hat tile,
    z tile, ok (B, s_local))."""
    b = words.shape[0]
    n = mesh.size(axis_name)
    zx, zy = out_shape[0] // 16, out_shape[1] // 16
    z, ok = _decode_tile(words.to(mesh.device), true_counts.to(mesh.device),
                         lane_cdf, t_steps,
                         (b, zx // n, zy, _latent_channels(cfg)))
    return spatial.synthesis_local(params, z, cfg, mesh, axis_name,
                                   None), z, ok


def shard_streams(words: np.ndarray, counts: np.ndarray, mesh: Mesh,
                  axis_name: str = "x") -> Tuple[torch.Tensor, torch.Tensor]:
    """Host (B, S, cap) u16 words and (B, S) counts -> this rank's
    (B, S/n, cap) int16 and (B, S/n) int32 tensors on ``mesh.device``."""
    n = mesh.size(axis_name)
    s_local = words.shape[1] // n
    part = slice(mesh.coord(axis_name) * s_local,
                 (mesh.coord(axis_name) + 1) * s_local)
    w = np.ascontiguousarray(words[:, part]).astype(np.uint16, copy=False)
    return (torch.from_numpy(w.view(np.int16)).to(mesh.device),
            torch.from_numpy(np.ascontiguousarray(counts[:, part], np.int32))
            .to(mesh.device))


class ShardedIntCodec:
    """Container-level sharded serving wrapper for the int8 codec.

    The transforms run spatially tiled on the kernel-A weights ``net``
    packed once (``spatial.net_analysis_local`` / ``net_synthesis_local``);
    each rank codes the spatial streams of its own latent tile on kernels B
    and C.  Containers are byte-identical to single-device
    ``int_codec.compress_batch`` with S = n_ranks * s_local streams and the
    same lane_mult, so single-device and sharded deployments interoperate.

    SPMD: every rank calls ``compress_batch`` with the same global images
    and gets the same containers; every rank calls ``decompress_batch``
    with the same containers and gets its own (x_hat, z) tiles (X cut over
    the mesh).  Where the stream plan does not tile over the mesh, both
    fall back to the single-device codec on this rank's device, and every
    rank then holds the whole result.  ``routes`` counts the calls by
    route ("sharded", "fallback")."""

    def __init__(self, net: IntCodecNet, static_cdfs: np.ndarray,
                 mesh: Mesh, cfg: ModelConfig = REFERENCE_NET, *,
                 lane_mult: int = int_codec.DEFAULT_LANE_MULT,
                 axis_name: str = "x"):
        if mesh.axis_names != (axis_name,):
            raise ValueError(f"ShardedIntCodec tiles X over a 1-D mesh "
                             f"named {axis_name!r}, not {mesh.axis_names}")
        if net.device != mesh.device:
            raise ValueError(f"the net lies on {net.device}, the mesh's "
                             f"rank on {mesh.device}")
        self.net = net
        self.static_cdfs = static_cdfs
        self.mesh = mesh
        self.cfg = cfg
        self.lane_mult = lane_mult
        self.axis = axis_name
        self.n = mesh.size(axis_name)
        self.routes = {"sharded": 0, "fallback": 0}

    def _plan(self, xd: int, yd: int) -> tuple:
        """The single-device stream plan for this geometry; the sharded
        path must realize the SAME plan (s_local = S / n) for byte
        identity.  Raises ValueError where it does not tile."""
        zx, zy = xd // 16, yd // 16
        s, lm = int_codec.plan_streams(zx * zy, self.lane_mult)
        if s % self.n or zx % self.n:
            raise ValueError(f"stream plan S={s}, zx={zx} does not tile "
                             f"over {self.n} ranks")
        c = _latent_channels(self.cfg)
        return zx, zy, c, s, lm * c, (zx * zy) // lm // s

    def _tiles(self, xd: int, yd: int) -> bool:
        """True iff this geometry's stream plan lands on tile boundaries,
        probed through ``_plan`` itself so that the two cannot drift."""
        try:
            self._plan(xd, yd)
            return True
        except ValueError:
            return False

    def _cdf(self, n_lanes: int) -> torch.Tensor:
        return int_codec._lane_cdf_tensor(self.static_cdfs, n_lanes,
                                          self.mesh.device)

    def compress_batch(self, x: torch.Tensor) -> List[bytes]:
        """x: the global (B, X, Y, 3) uint8/int8 images, the same on every
        rank -> B containers, the same on every rank."""
        b, xd, yd, _ = x.shape
        if not self._tiles(xd, yd):
            # a geometry whose stream plan does not tile over the mesh:
            # the single-device codec (one container format, so consumers
            # cannot tell)
            self.routes["fallback"] += 1
            return int_codec.compress_batch(
                self.net, x.to(self.net.device), self.static_cdfs,
                coder="device", lane_mult=self.lane_mult)
        self.routes["sharded"] += 1
        zx, zy, c, s, n_lanes, t_steps = self._plan(xd, yd)
        z = spatial.net_analysis_local(
            self.net, spatial.shard_image(x, self.mesh), self.mesh,
            self.axis)
        words, counts = _encode_tile(z, self._cdf(n_lanes), s // self.n,
                                     t_steps)
        # stream j of image i lives on rank j // s_local
        counts_np = _all_gather(counts, self.mesh).transpose(1, 0, 2)
        mxb = min(device_rans.bucket_words(int(counts_np.max())),
                  words.shape[2])
        words_np = _all_gather(words[:, :, :mxb], self.mesh)
        chunks = device_rans.streams_from_words(
            words_np.transpose(1, 0, 2, 3).reshape(b * s, mxb)
            .view(np.uint16), counts_np.reshape(b * s), t_steps * n_lanes,
            n_lanes)
        header = struct.pack("<HHHHH", xd, yd, zx, zy, c)
        return [container.pack(container.CODEC_INT8, [
            header, b"", int_codec._pack_streams(chunks[i * s:(i + 1) * s])])
            for i in range(b)]

    def decompress_batch(self, blobs: Sequence[bytes]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same B containers on every rank -> this rank's (x_hat,
        z) tiles; raises ValueError on every rank when any rank finds a
        corrupt stream."""
        metas = int_codec._parse(blobs)
        if any(m[1] for m in metas):
            raise ValueError("sharded decode expects static-table int8 "
                             "containers")
        (xd, yd, zx, zy, c) = metas[0][0]
        if not self._tiles(xd, yd):
            # the same single-device fallback as compress_batch
            self.routes["fallback"] += 1
            return int_codec.decompress_batch(self.net, blobs,
                                              self.static_cdfs,
                                              coder="device")
        zx2, zy2, c2, s, n_lanes, t_steps = self._plan(xd, yd)
        if (zx, zy, c) != (zx2, zy2, c2) or len(metas[0][2]) != s:
            raise ValueError(f"containers of {len(metas[0][2])} streams "
                             f"over a ({zx}, {zy}, {c}) latent; the plan "
                             f"has {s} over ({zx2}, {zy2}, {c2})")
        self.routes["sharded"] += 1
        b, s_local = len(metas), s // self.n
        first = self.mesh.coord(self.axis) * s_local
        words, counts = int_codec._upload_streams(
            [chunk for m in metas for chunk in m[2][first:first + s_local]],
            self.mesh.device)
        z, ok = _decode_tile(words.view(b, s_local, -1),
                             counts.view(b, s_local), self._cdf(n_lanes),
                             t_steps, (b, zx // self.n, zy, c))
        x_hat = spatial.net_synthesis_local(self.net, z, self.mesh,
                                            self.axis)
        flag = ok.all().to(torch.int32).reshape(1).to(self.mesh.comm_device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if not int(flag):
            raise ValueError("corrupt stream in sharded decode")
        return x_hat, z
