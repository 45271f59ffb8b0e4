"""Spatial tiling of the integer codec across ranks with halo exchange.

The counterpart of the JAX package's ``parallel/spatial.py``.  The image's X
(and optionally Y) axis is tiled over a rank mesh (``mesh.py``); before each
layer neighbouring ranks exchange the border rows the layer's receptive
field needs, through ``torch.distributed`` point-to-point messages (JAX's
``ppermute``).  Every layer's local computation is the global conv
restricted to the tile, so the tiled output is bit-identical to one device.

JAX holds one global array under one controller; here each rank is a
process holding its own tile (SPMD): ``shard_image`` cuts this rank's tile
from a global tensor, ``eight_layers_net_sharded`` takes and returns tiles,
and ``gather_image`` assembles the whole image on every rank.

Per-layer kernels follow the plan's names, as in the JAX package: the s2d /
d2s forms (``s2d``, ``pallas``, ``pallas2``, ``gemm``; ``d2s``, ``pd2s``,
``pd2s2``) on kernel A and ``pallas3`` / ``pd2s3`` on kernel F, each in its
VALID halo mode on both axes (the exchanged halo, or zeros on an unsharded
axis, replaces the kernel's own padding); ``lax`` is the plain golden.
``net_analysis_local`` / ``net_synthesis_local`` run the same layers on the
weights ``IntCodecNet`` packed once, for the sharded codec.

Key facts used:

* conv k5/s2/p2 needs a 2-pixel halo on each side; the stride phase stays
  aligned because tile sizes are even.  In the s2d form that halo is
  exactly 1 s2d pixel;
* deconv (as the d2s 3x3 stride-1 form) needs a 1-pixel halo;
* where no neighbour exists the halo is zeros, the reference's zero padding
  at the global image borders;
* on a 2-D mesh X is exchanged first, then Y on the X-extended tile, so the
  corner pixels arrive in two hops.

On a backend that moves host tensors only (gloo) while the tiles lie on a
card, each message is staged through pinned host memory, counted in
``halo_exchange.staged_bytes``; NCCL takes the device tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..config import ModelConfig, REFERENCE_NET
from ..models import codec_int
from ..ops import conv_fast, conv_int, cuda_conv
from .mesh import Mesh

_CONV_IMPLS = ("pallas", "pallas2", "pallas3", "s2d", "gemm", "lax")
_DECONV_IMPLS = ("d2s", "pd2s", "pd2s2", "pd2s3")


def _outbound(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A message as the backend sends it: a pinned host copy where the
    mesh stages through the host (counted), else ``t`` contiguous."""
    if not mesh.staged:
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    halo_exchange.staged_bytes += buf.numel() * buf.element_size()
    return buf


def _inbound(like: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if not mesh.staged:
        return torch.empty_like(like)
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _zero_border(h: torch.Tensor, halo: int, dim: int) -> torch.Tensor:
    shape = list(h.shape)
    shape[dim] = halo
    return h.new_zeros(shape)


def _concat(h: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            dim: int) -> torch.Tensor:
    return torch.cat([lo.to(h.device, non_blocking=True), h,
                      hi.to(h.device, non_blocking=True)], dim)


def _swap(to_lo: torch.Tensor, to_hi: torch.Tensor, from_lo: torch.Tensor,
          from_hi: torch.Tensor, mesh: Mesh, axis: str
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_lo`` to the mesh neighbour below along ``axis`` and
    ``to_hi`` to the one above, and receive what each sends back, shaped
    as ``from_lo`` / ``from_hi`` (zeros, kept where there is no
    neighbour).  Returns the two received tensors, on the mesh's
    backend's side (host memory when staged)."""
    lo_rank, hi_rank = mesh.neighbours(axis)
    got, ops, recv = [from_lo, from_hi], [], []
    for side, (peer, out) in enumerate(((lo_rank, to_lo), (hi_rank, to_hi))):
        if peer is None:
            continue
        got[side] = _inbound(got[side], mesh)
        recv.append(got[side])
        ops += [dist.P2POp(dist.isend, _outbound(out, mesh), peer),
                dist.P2POp(dist.irecv, got[side], peer)]
    for work in (dist.batch_isend_irecv(ops) if ops else ()):
        work.wait()
    if mesh.staged:
        halo_exchange.staged_bytes += sum(
            g.numel() * g.element_size() for g in recv)
    return got[0], got[1]


def halo_exchange(h: torch.Tensor, halo: Union[int, Tuple[int, int]],
                  mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate boundary slices from both mesh neighbours along
    ``axis`` onto tensor dim ``dim`` (zeros past the global ends):
    ``halo`` slices on each side, or a (before, after) pair.  With one
    rank on the axis this is a zero pad."""
    before, after = (halo, halo) if isinstance(halo, int) else halo
    # the rank below takes this tile's first ``after`` slices, the rank
    # above its last ``before``
    lo, hi = _swap(h.narrow(dim, 0, after),
                   h.narrow(dim, h.shape[dim] - before, before),
                   _zero_border(h, before, dim), _zero_border(h, after, dim),
                   mesh, axis)
    return _concat(h, lo, hi, dim)


halo_exchange.staged_bytes = 0


class _HaloGrad(torch.autograd.Function):
    """``halo_exchange`` whose backward sends each received halo's
    gradient back to the rank that owns those slices, which adds it into
    its boundary gradient (a halo past the global ends was zeros: its
    gradient goes nowhere).  Every rank of the axis must run the same
    backward, as every rank runs the same forward."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, before: int, after: int, mesh: Mesh,
                axis: str, dim: int) -> torch.Tensor:
        ctx.halo = (before, after, mesh, axis, dim)
        return halo_exchange(h, (before, after), mesh, axis, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        before, after, mesh, axis, dim = ctx.halo
        n = g.shape[dim] - before - after
        # the rank below sent this tile's first ``before`` slices: their
        # gradient goes back to it, and it returns the gradient of the
        # ``after`` slices it took from this tile (the rank above alike)
        lo, hi = _swap(g.narrow(dim, 0, before),
                       g.narrow(dim, before + n, after),
                       _zero_border(g, after, dim),
                       _zero_border(g, before, dim), mesh, axis)
        out = g.narrow(dim, before, n).clone()
        out.narrow(dim, 0, after).add_(lo.to(g.device))
        out.narrow(dim, n - before, before).add_(hi.to(g.device))
        return out, None, None, None, None, None


def halo_exchange_grad(h: torch.Tensor,
                       halo: Union[int, Tuple[int, int]], mesh: Mesh,
                       axis: str, dim: int) -> torch.Tensor:
    """``halo_exchange`` with gradients: the same values, and a backward
    that carries the halos' gradients back to their owners (what GSPMD
    gives a sharded conv in the JAX package).  Under ``torch.no_grad`` it
    is ``halo_exchange``."""
    before, after = (halo, halo) if isinstance(halo, int) else halo
    return _HaloGrad.apply(h, before, after, mesh, axis, dim)


def halo_exchange_x(h: torch.Tensor, halo: int, mesh: Mesh,
                    axis: str = "x") -> torch.Tensor:
    return halo_exchange(h, halo, mesh, axis, 1)


def _halo_or_pad(h: torch.Tensor, halo: int, mesh: Mesh,
                 axis: Optional[str], dim: int) -> torch.Tensor:
    """Halo-exchange a sharded dim, zero-pad an unsharded one (identical
    semantics: the global border is zeros either way)."""
    if axis is None:
        zeros = _zero_border(h, halo, dim)
        return _concat(h, zeros, zeros, dim)
    return halo_exchange(h, halo, mesh, axis, dim)


def _extend(h: torch.Tensor, halo: int, mesh: Mesh, ax: Optional[str],
            ay: Optional[str]) -> torch.Tensor:
    """The tile with its halo on both image axes: X first, then Y on the
    X-extended tile (which carries the corners)."""
    return _halo_or_pad(_halo_or_pad(h, halo, mesh, ax, 1), halo, mesh, ay,
                        2)


def _conv_local(h: torch.Tensor, w, b, impl: str, mesh: Mesh,
                ax: Optional[str], ay: Optional[str]) -> torch.Tensor:
    """One strided k5/s2 conv layer on a local tile: halo 2 + VALID conv.

    All impls are bit-identical; the s2d names run the s2d rewrite on
    kernel A (halo 2 px == 1 s2d pixel), "pallas3" kernel F, "lax" the
    direct k5 golden.  Spatial plans accept only these names, as in the
    JAX package."""
    if impl not in _CONV_IMPLS:
        raise ValueError(f"unsupported sharded conv impl {impl!r}")
    hx = _extend(conv_int.to_wire_int8(h), 2, mesh, ax, ay)
    dev = hx.device
    if impl == "pallas3":
        return cuda_conv.conv2d_int8_pallas3(hx, w, b, x_valid=True,
                                             y_valid=True)
    if impl == "lax":
        return conv_int.conv2d_int8(hx, conv_fast.as_int8(w).to(dev),
                                    conv_fast.as_int8(b).to(dev), padding=0)
    xs = conv_fast.space_to_depth(hx).contiguous()
    return cuda_conv.conv3x3_s1_int8_any(
        xs, conv_fast.conv_weights_s2d(w).to(dev),
        conv_fast.as_int8(b).to(dev), x_valid=True, y_valid=True)


def _deconv_local(h: torch.Tensor, w, b, impl: str, mesh: Mesh,
                  ax: Optional[str], ay: Optional[str]) -> torch.Tensor:
    """One transposed-conv layer on a local tile: halo 1 + d2s 3x3 conv,
    the epilogue on the phase form, then depth-to-space.  On the card the
    JAX package's XLA ``d2s`` form is kernel A, as in the single-device
    port."""
    if impl not in _DECONV_IMPLS:
        raise ValueError(f"unsupported sharded deconv impl {impl!r}")
    hx = _extend(conv_int.to_wire_int8(h), 1, mesh, ax, ay).contiguous()
    if impl == "pd2s3":
        return cuda_conv.deconv2d_int8_pallas3(hx, w, b, x_valid=True,
                                               y_valid=True)
    y = cuda_conv.conv3x3_s1_int8_any(
        hx, conv_fast.deconv_weights_d2s(w).to(hx.device),
        conv_fast.tile_bias(b, 4).to(hx.device), x_valid=True, y_valid=True)
    return conv_fast.depth_to_space(y)


def _plan(impl, cfg: ModelConfig) -> tuple:
    plan = codec_int.DEFAULT_PLAN if impl is None else tuple(impl)
    if len(plan) != len(cfg.layers):
        raise ValueError(f"plan has {len(plan)} entries for "
                         f"{len(cfg.layers)} layers")
    # The fused deconv pair ("tailfused") is a single-device schedule: this
    # net applies layers one at a time with per-layer halo exchanges, so
    # the pair runs in its unfused d2s form (bit-identical).
    return tuple("d2s" if p == "tailfused" else p for p in plan)


def analysis_local(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, mesh: Mesh, ax: Optional[str],
                   ay: Optional[str], impl=None) -> torch.Tensor:
    plan = _plan(impl, cfg)
    h = conv_int.to_wire_int8(x)
    for i, _ in enumerate(cfg.analysis):
        h = _conv_local(h, params[f"w{i}"], params[f"b{i}"], plan[i], mesh,
                        ax, ay)
    return h


def synthesis_local(params: Dict[str, torch.Tensor], z: torch.Tensor,
                    cfg: ModelConfig, mesh: Mesh, ax: Optional[str],
                    ay: Optional[str], impl=None) -> torch.Tensor:
    plan = _plan(impl, cfg)
    h = z.to(torch.int8)
    na = len(cfg.analysis)
    for j, _ in enumerate(cfg.synthesis):
        i = na + j
        h = _deconv_local(h, params[f"w{i}"], params[f"b{i}"], plan[i],
                          mesh, ax, ay)
    return h


def net_analysis_local(net: "codec_int.IntCodecNet", x: torch.Tensor,
                       mesh: Mesh, ax: Optional[str] = "x",
                       ay: Optional[str] = None) -> torch.Tensor:
    """``analysis_local`` under the default plan on the kernel-A weights
    ``net`` packed once: uint8/int8 tile -> int8 latent tile."""
    h = conv_int.to_wire_int8(x.to(net.device))
    for i in range(4):
        hx = _extend(h, 2, mesh, ax, ay)
        h = net._layer(i, conv_fast.space_to_depth(hx).contiguous(),
                       valid=True)
    return h


def net_synthesis_local(net: "codec_int.IntCodecNet", z: torch.Tensor,
                        mesh: Mesh, ax: Optional[str] = "x",
                        ay: Optional[str] = None) -> torch.Tensor:
    """``synthesis_local`` on ``net``'s packed weights.  The last two
    deconvs stay fused as ``net`` holds them: layer 6's phase form is the
    s2d of its output, so a 1-pixel halo of the phase form (2 output
    pixels) feeds layer 7's s2dtail conv; the result equals the unfused
    pair's, bit for bit."""
    h = z.to(device=net.device, dtype=torch.int8)
    for i in (4, 5):
        h = conv_fast.depth_to_space(
            net._layer(i, _extend(h, 1, mesh, ax, ay).contiguous(),
                       valid=True)).contiguous()
    p6 = net._layer(6, _extend(h, 1, mesh, ax, ay).contiguous(), valid=True)
    return conv_fast.depth_to_space4(
        net._layer(7, _extend(p6, 1, mesh, ax, ay).contiguous(), valid=True))


def _axes_of(axis_names: Sequence[str]
             ) -> Tuple[str, Optional[str]]:
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    return axis_names[0], (axis_names[1] if len(axis_names) > 1 else None)


def eight_layers_net_sharded(params: Dict[str, torch.Tensor],
                             x_tile: torch.Tensor, mesh: Mesh,
                             cfg: ModelConfig = REFERENCE_NET,
                             axis_names: Sequence[str] = ("x",),
                             impl=None) -> torch.Tensor:
    """Full codec forward on this rank's tile of an image whose X (and
    optionally Y) axis is tiled over ``mesh``; returns this rank's tile of
    the reconstruction, on ``mesh.device``.

    ``axis_names``: 1 or 2 mesh axis names tiling the image's X / Y dims.
    The gathered tiles are bit-identical to ``codec_int.eight_layers_net``
    on the whole image."""
    ax, ay = _axes_of(axis_names)
    nx = mesh.size(ax)
    if x_tile.shape[1] % 16:
        raise ValueError(
            f"X={x_tile.shape[1] * nx} must divide into {nx} even tiles at "
            f"the latent (need X % {16 * nx} == 0)")
    if ay is not None and x_tile.shape[2] % 16:
        raise ValueError(
            f"Y={x_tile.shape[2] * mesh.size(ay)} must divide into "
            f"{mesh.size(ay)} even tiles at the latent")
    x = x_tile.to(mesh.device)
    return synthesis_local(params,
                           analysis_local(params, x, cfg, mesh, ax, ay, impl),
                           cfg, mesh, ax, ay, impl)


def shard_image(x: torch.Tensor, mesh: Mesh,
                axis_names: Sequence[str] = ("x",)) -> torch.Tensor:
    """This rank's tile of a global (B, X, Y, C) image, on ``mesh.device``:
    X (and optionally Y) cut evenly over the named mesh axes."""
    for axis, dim in zip(_axes_of(axis_names), (1, 2)):
        if axis is None:
            continue
        n = mesh.size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"extent {x.shape[dim]} does not split into "
                             f"{n} tiles")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.coord(axis) * step, step)
    return x.contiguous().to(mesh.device)


def all_gather(t: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's ``t`` (one shape and dtype on all), in rank order, on
    ``mesh.comm_device``.  The tensors travel as bytes: neither gloo nor
    NCCL gathers every dtype (int16 words, for one)."""
    raw = t.contiguous().to(mesh.comm_device).reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, raw)
    return [p.view(t.dtype).reshape(t.shape) for p in parts]


def gather_image(tile: torch.Tensor, mesh: Mesh,
                 axis_names: Sequence[str] = ("x",)) -> torch.Tensor:
    """The whole image from every rank's tile (an all-gather), on every
    rank, on the tile's device: the inverse of ``shard_image``.  Ranks
    that differ only along a mesh axis not named hold the same tile."""
    ax, ay = _axes_of(axis_names)
    parts = all_gather(tile, mesh)
    ix = mesh.axis_names.index(ax)
    iy = None if ay is None else mesh.axis_names.index(ay)
    grid: Dict[tuple, torch.Tensor] = {}
    for r, part in enumerate(parts):
        c = mesh.coords(r)
        grid.setdefault((c[ix], 0 if iy is None else c[iy]), part)
    ny = 1 if ay is None else mesh.size(ay)
    rows = [torch.cat([grid[(i, j)] for j in range(ny)], 2)
            for i in range(mesh.size(ax))]
    return torch.cat(rows, 1).to(tile.device)
