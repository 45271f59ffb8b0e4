"""Bitstream codecs for the scale- and mean-scale-hyperprior models.

The counterpart of the JAX package's ``codec/hyper_codec.py``, in two
formats, each byte-identical with the JAX package's for the same integers:

* ``compress``/``decompress``: one image, container ``CODEC_HYPERPRIOR``,
  coded on the host serial coder (``codec/rans.py``): z with the learned
  factorized CDFs, one row a channel; round(y) over [-255, 255] with the
  64 scale-binned Gaussian tables, the row of each symbol its scale bin
  (``entropy.scale_to_index`` on the host); out-of-range values as an
  escape symbol with a bypass-coded raw value inside the stream.
* ``compress_batch``/``decompress_batch``: the device format, container
  ``CODEC_HYPERPRIOR_DEV``, on the card:

encode: x -> g_a -> y; h_a -> z_hat = round(z); (mu,) sigma = h_s(z_hat);
        z_hat coded with the learned factorized CDFs, one fixed row per
        lane (kernel B); round(y) (mean-scale: round(y - mu)) coded with
        the 64 scale-binned Gaussian tables, the row of each symbol picked
        by its scale bin (kernel D).
decode: z from its streams (kernel C) -> (mu,) sigma -> scale bins -> y
        from its streams (kernel E) (mean-scale: + mu, in float32) ->
        g_s(y_hat).

Both sides derive the scale bins (and mu) from the same z_hat with the
same program (``_prior_from_z``), so y_hat equals the encoder's rounded y
(or its symbols plus mu) exactly.  Each direction is a
schedule phase, which enqueues the device work and an asynchronous copy of
what the host needs, and a drain phase, which waits for that copy alone and
packs or checks (``_compress_schedule``/``_compress_drain``,
``_decompress_schedule``/``_decompress_drain``, as in the JAX package):
``codec/pipeline.py`` overlaps one batch's drain with the next one's
device work.  Values outside the
tables' alphabets ([-63, 63] for z, [-127, 127] for y) are coded as an
escape symbol and carried raw in side sections (``codec/escape.py``).

``HyperCodec`` serves ``ScaleHyperprior``, ``MeanScaleCodec`` serves
``MeanScaleHyperprior``; either model may run in bf16 (the serving fast
path), whose codec is consistent with itself only: its containers decode
with the bf16 model, not with the float32 one.
"""

from __future__ import annotations

import copy
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.hyperprior import MeanScaleHyperprior, ScaleHyperprior
from ..utils import profiling
from . import (container, cuda_rans, device_rans, entropy, escape, ilrans,
               rans)
from .int_codec import _pack_streams, _unpack_streams, plan_streams

_Z_MAX = 63       # hyper-latent support [-63, 63] + escape
_Y_MAX = 255      # latent support [-255, 255] + escape (host serial format)
_Y_MAX_DEV = 127  # latent support [-127, 127] + escape (device format)


def build_factorized_cdfs(model: ScaleHyperprior,
                          max_abs: int = _Z_MAX) -> np.ndarray:
    """(N, 2*max_abs + 3) int32: the learned per-channel density of z on
    the integer grid, plus the overflow (escape) bucket.  Evaluated on the
    host in float32 wherever the model lives, so both ends of a link build
    the same table."""
    bottleneck = copy.deepcopy(model.bottleneck).to("cpu")
    grid = torch.arange(-max_abs, max_abs + 1, dtype=torch.float32)
    with torch.no_grad():
        pmf = bottleneck.likelihood(
            grid[:, None].repeat(1, bottleneck.channels)).numpy()
    rows = []
    for ch in range(bottleneck.channels):
        p = pmf[:, ch]
        overflow = max(1.0 - p.sum(), 0.0)
        rows.append(entropy.quantize_cdf(np.append(p, overflow)))
    return np.stack(rows)


def build_gaussian_cdfs(scale_table: np.ndarray, max_abs: int) -> np.ndarray:
    """(len(scale_table), 2*max_abs + 3) int32 Gaussian tables."""
    return np.stack([entropy.gaussian_cdf_table(s, max_abs)
                     for s in scale_table])


def _code(vals: np.ndarray, ctx: np.ndarray, cdfs: np.ndarray,
          max_abs: int) -> bytes:
    """Integers -> serial stream: values in [-max_abs, max_abs] as symbols
    0..2*max_abs, the rest as the escape symbol with the raw value
    bypass-coded after it."""
    syms = np.clip(vals, -max_abs, max_abs) + max_abs
    syms = np.where(np.abs(vals) > max_abs, cdfs.shape[1] - 2, syms)
    return rans.encode(syms.ravel(), ctx.ravel(), cdfs, raw=vals.ravel())


def _decode(data: bytes, n: int, ctx: np.ndarray, cdfs: np.ndarray,
            max_abs: int) -> np.ndarray:
    syms, raw = rans.decode(data, n, ctx, cdfs)
    return np.where(syms == cdfs.shape[1] - 2, raw, syms - max_abs)


def _plan_lanes(n_pix: int, channels: int, lane_mult: int = 2,
                n_streams: int = 8) -> Tuple[int, int, int]:
    """-> (n_streams, n_lanes, t_steps) for a (P, C) channel-fastest latent."""
    s, lm = plan_streams(n_pix, lane_mult, n_streams)
    n_lanes = lm * channels
    return s, n_lanes, (n_pix // lm) // s


def _patch_escapes(vals: torch.Tensor, raws: Sequence[bytes],
                   max_abs: int) -> torch.Tensor:
    """Decoded values (escapes as max_abs + 1) + raw side sections ->
    exact values.  Host work, only for batches that carry raws."""
    if not any(escape.unpack_raw(r)[0].size for r in raws):
        return vals
    with profiling.span("wait", escape_syncs=1):
        syms = vals.cpu().numpy() + max_abs
    out = np.stack([escape.from_symbols(syms[i], escape.unpack_raw(r)[0],
                                        max_abs).reshape(syms.shape[1:])
                    for i, r in enumerate(raws)])
    return torch.from_numpy(out.astype(np.int32)).to(vals.device)


def pack_dev(geometry: Tuple[int, ...], z_streams: Sequence[bytes],
             y_streams: Sequence[bytes], z: Optional[np.ndarray] = None,
             y: Optional[np.ndarray] = None) -> bytes:
    """One image's ``CODEC_HYPERPRIOR_DEV`` container: the header (X, Y,
    zx, zy, zc, yx, yy, yc), its streams, and the raw side sections of the
    values of ``z`` and ``y`` outside the alphabets (empty without them)."""
    return container.pack(container.CODEC_HYPERPRIOR_DEV, [
        struct.pack("<HHHHHHHH", *geometry), _pack_streams(z_streams),
        _pack_streams(y_streams),
        escape.pack_raw(np.zeros(0) if z is None else z, _Z_MAX),
        escape.pack_raw(np.zeros(0) if y is None else y, _Y_MAX_DEV)])


def parse_dev(blobs: Sequence[bytes]) -> List[Tuple]:
    """``CODEC_HYPERPRIOR_DEV`` containers of one geometry -> per container
    (header (X, Y, zx, zy, zc, yx, yy, yc), z streams, y streams, z raw
    section, y raw section).  Raises ValueError for another container or
    mixed geometries."""
    with profiling.span("parse"):
        metas = []
        for data in blobs:
            cid, sections = container.unpack(data)
            if cid != container.CODEC_HYPERPRIOR_DEV or len(sections) != 5:
                raise ValueError("not a device-format hyperprior container")
            hdr, z_pay, y_pay, z_raw, y_raw = sections
            metas.append((struct.unpack("<HHHHHHHH", hdr),
                          _unpack_streams(z_pay), _unpack_streams(y_pay),
                          z_raw, y_raw))
        if any(m[0] != metas[0][0] for m in metas):
            raise ValueError("mixed geometries in one batch")
    return metas


def _image_by_image(fn: Callable, z_hat: torch.Tensor) -> list:
    """fn (h_s) on each image of z_hat alone.  Both ends must derive
    bitwise-equal scales (and means) from an image's z_hat, whatever batch
    it was encoded or is decoded in, and cuDNN and oneDNN choose their
    algorithms, and so their sums' order, by shape: on the card the
    mean-scale h_s at B = 1 and 8 put sigmas of B = 2 containers across
    scale-bin edges.  At B = 1 the program is one, whatever the batch."""
    return [fn(z_hat[i:i + 1]) for i in range(z_hat.shape[0])]


class HyperCodec:
    """Encoder/decoder pair for ``ScaleHyperprior``, sharing its tables.
    The model's prior enters through one hook, ``_prior_from_z``, which
    ``MeanScaleCodec`` overrides.

    The transforms run on the model's device.  ``compress``/``decompress``
    are the host serial format; ``compress_batch``/``decompress_batch``
    the device format, whose tables live on the device once built."""

    model_cls = ScaleHyperprior     # what ``from_checkpoint`` loads

    def __init__(self, model: ScaleHyperprior):
        self.model = model
        self.scale_table = entropy.default_scale_table()
        self.z_cdfs = build_factorized_cdfs(model)
        self.y_cdfs = build_gaussian_cdfs(self.scale_table, _Y_MAX)
        self.y_cdfs_dev = build_gaussian_cdfs(self.scale_table, _Y_MAX_DEV)
        self._tables: Dict[Tuple, torch.Tensor] = {}
        # uploaded once: an upload from pageable memory waits for the stream
        self._scale_bounds = torch.tensor(self.scale_table,
                                          dtype=torch.float32,
                                          device=self.device)
        # bucketed word widths for the copy the schedule phase starts,
        # learned from the previous batch's counts
        self._mxb_z: Optional[int] = None
        self._mxb_y: Optional[int] = None

    @classmethod
    def from_checkpoint(cls, path: str, device=None,
                        dtype: torch.dtype = torch.float32) -> "HyperCodec":
        """A codec for the JAX package's ``hp_scale_*.params.msgpack``
        (``MeanScaleCodec``: ``hp_meanscale_*``), its model in ``dtype``."""
        return cls(cls.model_cls.from_checkpoint(path, device=device,
                                                 dtype=dtype))

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _dev_table(self, key: Tuple, build: Callable[[], np.ndarray]
                   ) -> torch.Tensor:
        """Device-resident int32 CDF table, uploaded once per geometry."""
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(np.ascontiguousarray(
                build(), np.int32)).to(self.device)
        return self._tables[key]

    def _z_lane_cdf(self, n_lanes: int) -> torch.Tensor:
        zc = self.z_cdfs.shape[0]
        return self._dev_table(("z_lane", n_lanes), lambda: self.z_cdfs[
            np.arange(n_lanes) % zc])

    def _y_table(self) -> torch.Tensor:
        return self._dev_table(("y",), lambda: self.y_cdfs_dev)

    def _scale_ctx(self, sigma: torch.Tensor) -> torch.Tensor:
        """Scale bin of each latent: #{k: table[k] < sigma}, clipped to the
        last bin.  The table is compared in float32, as the JAX package
        does: a float64 table puts some sigmas in other bins."""
        idx = torch.searchsorted(self._scale_bounds,
                                 sigma.to(torch.float32).contiguous())
        return idx.clamp(0, len(self.scale_table) - 1).to(torch.int32)

    def _prior_from_z(self, z_hat: torch.Tensor
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """-> (mu, or None for the scale model, sigma) from z_hat (B, zx,
        zy, N) float32: h_s image by image (``_image_by_image``)."""
        return None, torch.cat(_image_by_image(self.model.scales_from_z,
                                               z_hat))

    # --- encode ---------------------------------------------------------
    def encode_arrays(self, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor], torch.Tensor]:
        """x (B, X, Y, 3) in [0, 1] -> (symbols int32, z_hat int32, mu
        float32 or None, sigma float32), NHWC on the device.  The symbols
        are round(y), or round(y - mu) (half to even, as ``jnp.round``).
        mu and sigma come from the quantized z_hat through
        ``_prior_from_z``, the decoder's own program."""
        y, z_hat = self.model.analysis_arrays(x)
        mu, sigma = self._prior_from_z(z_hat)
        sym = torch.round(y if mu is None else y - mu)
        return sym.to(torch.int32), z_hat.to(torch.int32), mu, sigma

    def encode_parts(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``encode_arrays`` without mu: (symbols, z_hat, sigma)."""
        sym, z, _, sigma = self.encode_arrays(x)
        return sym, z, sigma

    def compress_batch(self, x: torch.Tensor) -> List[bytes]:
        """(B, X, Y, 3) [0, 1] images, X and Y multiples of 64 -> B
        ``CODEC_HYPERPRIOR_DEV`` containers: ``_compress_drain`` of
        ``_compress_schedule``."""
        return self._compress_drain(self._compress_schedule(x))

    def _compress_schedule(self, x: torch.Tensor) -> Tuple:
        """Enqueue one batch's device work and the copy of what the host
        needs; no wait on the device.  Returns the state that
        ``_compress_drain`` packs, so that a pipeline packs batch k while
        batch k+1 runs (``pipeline.HyperPipelinedEncoder``)."""
        if x.shape[1] % 64 or x.shape[2] % 64:
            raise ValueError("hyperprior codecs need image sides divisible "
                             "by 64 (16x analysis, 4x hyper stage)")
        with profiling.span("enqueue"):
            y, z, sigma = self.encode_parts(x)
            return self._entropy_schedule(y, z, self._scale_ctx(sigma),
                                          x.shape[1], x.shape[2])

    def entropy_encode(self, y: torch.Tensor, z: torch.Tensor,
                       ctx_y: torch.Tensor, ix: int, iy: int) -> List[bytes]:
        """Integer y (B, yx, yy, M), z (B, zx, zy, N) and y's scale bins
        -> B containers."""
        return self._compress_drain(
            self._entropy_schedule(y, z, ctx_y, ix, iy))

    def _entropy_schedule(self, y: torch.Tensor, z: torch.Tensor,
                          ctx_y: torch.Tensor, ix: int, iy: int) -> Tuple:
        """Two kernel launches (z on B, y on D), then ONE copy to pinned
        host memory of the counts, the escape totals and both tensors'
        words, each cut at the width the previous batch needed (``_mxb_z``,
        ``_mxb_y``; the whole width at first), with an event after it.

        The JAX package re-encodes a tensor on its scan engine when a count
        outgrows the compact kernel's staging cap.  Kernels B and D write
        into buffers sized for the worst case, one word a symbol
        (``cuda_rans.encode_batch_compact``), so no count can outgrow
        them and there is no re-encode."""
        b, yx, yy, yc = y.shape
        _, zx, zy, zc = z.shape
        s_z, nl_z, t_z = _plan_lanes(zx * zy, zc)
        s_y, nl_y, t_y = _plan_lanes(yx * yy, yc)
        zs = escape.to_symbols(z, _Z_MAX).to(torch.int8)
        zw, zcnt = cuda_rans.encode_batch_compact(
            zs.reshape(b * s_z, t_z, nl_z), self._z_lane_cdf(nl_z))
        ys = escape.to_symbols(y, _Y_MAX_DEV)
        yw, ycnt = cuda_rans.encode_batch_compact(
            ys.reshape(b * s_y, t_y, nl_y), self._y_table(),
            ctx=ctx_y.to(torch.int32).reshape(b * s_y, t_y, nl_y)
            .contiguous())
        z_esc = (z.abs() > _Z_MAX).reshape(b, -1).sum(1)
        y_esc = (y.abs() > _Y_MAX_DEV).reshape(b, -1).sum(1)
        w_z = min(self._mxb_z or zw.shape[1], zw.shape[1])
        w_y = min(self._mxb_y or yw.shape[1], yw.shape[1])
        meta = torch.cat([zcnt, ycnt, z_esc.to(torch.int32),
                          y_esc.to(torch.int32)])
        fetch = device_rans.to_host_async(torch.cat([
            zw[:, :w_z].reshape(-1), yw[:, :w_y].reshape(-1),
            meta.view(torch.int16)]))
        plan = (ix, iy, b, zx, zy, zc, yx, yy, yc,
                s_z, nl_z, t_z, s_y, nl_y, t_y)
        return plan, (w_z, w_y), fetch, z, y, zw, yw

    def _compress_drain(self, state: Tuple) -> List[bytes]:
        """Wait for a scheduled batch's copy and pack its containers.  A
        tensor whose longest stream outgrew the predicted width is fetched
        again, blocking; the widths for the next batch are learned here."""
        plan, (w_z, w_y), fetch, z, y, zw, yw = state
        (ix, iy, b, zx, zy, zc, yx, yy, yc,
         s_z, nl_z, t_z, s_y, nl_y, t_y) = plan
        buf = device_rans.host_array(fetch)
        n_wz, n_wy = b * s_z * w_z, b * s_y * w_y
        meta = buf[n_wz + n_wy:].view(np.int32)
        zcnt_np, ycnt_np = meta[:b * s_z], meta[b * s_z: b * (s_z + s_y)]
        z_esc_np = meta[b * (s_z + s_y): b * (s_z + s_y) + b]
        y_esc_np = meta[b * (s_z + s_y) + b:]
        zw_np, self._mxb_z = device_rans.words_at_need(
            zw, buf[:n_wz].view(np.uint16).reshape(b * s_z, w_z), zcnt_np)
        yw_np, self._mxb_y = device_rans.words_at_need(
            yw, buf[n_wz: n_wz + n_wy].view(np.uint16).reshape(b * s_y, w_y),
            ycnt_np)
        with profiling.span("pack"):
            z_chunks = device_rans.streams_from_words(
                zw_np, zcnt_np, t_z * nl_z, nl_z)
            y_chunks = device_rans.streams_from_words(
                yw_np, ycnt_np, t_y * nl_y, nl_y)
            z_np = y_np = None
            if z_esc_np.any():
                with profiling.span("wait", escape_syncs=1):
                    z_np = z.cpu().numpy()
            if y_esc_np.any():
                with profiling.span("wait", escape_syncs=1):
                    y_np = y.cpu().numpy()

            geometry = (ix, iy, zx, zy, zc, yx, yy, yc)
            return [pack_dev(
                geometry, z_chunks[i * s_z: (i + 1) * s_z],
                y_chunks[i * s_y: (i + 1) * s_y],
                z_np[i] if z_np is not None else None,
                y_np[i] if y_np is not None else None) for i in range(b)]

    # --- decode ---------------------------------------------------------
    def decompress_batch(self, blobs: Sequence[bytes], return_z: bool = False
                         ) -> Tuple[torch.Tensor, ...]:
        """B containers of one geometry -> (x_hat (B, X, Y, 3), y_hat
        (B, X/16, Y/16, M)) float32 on the device, and z_hat with
        ``return_z``.  Raises ValueError for a corrupt container (a stream
        whose words consumed != its length, or a final state != 2^16):
        ``_decompress_drain`` of ``_decompress_schedule``."""
        x_hat, y_hat, z_hat = self._decompress_drain(
            self._decompress_schedule(blobs))
        return (x_hat, y_hat, z_hat) if return_z else (x_hat, y_hat)

    def _decompress_schedule(self, blobs: Sequence[bytes]) -> Tuple:
        """Parse the containers on the host, upload both tensors' words
        and counts in one pinned copy, and enqueue the decodes (C on z, E
        on y), the scales between them and g_s; then the copy of the
        validity flags to pinned host memory, with an event after it.  No
        wait on the device, except to patch escapes into a batch that
        carries raw values."""
        metas = parse_dev(blobs)
        (_, _, zx, zy, zc, yx, yy, yc) = metas[0][0]
        b = len(blobs)
        s_z, nl_z, t_z = _plan_lanes(zx * zy, zc)
        s_y, nl_y, t_y = _plan_lanes(yx * yy, yc)
        if any(len(m[1]) != s_z or len(m[2]) != s_y for m in metas):
            raise ValueError("stream plan does not match the geometry")
        with profiling.span("stage"):
            zw_np, zc_np = device_rans.gather_words(
                [ch for m in metas for ch in m[1]])
            yw_np, yc_np = device_rans.gather_words(
                [ch for m in metas for ch in m[2]])
            # words first, so that each tensor's words start 16-byte
            # aligned (the caps are multiples of the bucket); the counts
            # after them
            staged = np.concatenate([
                zw_np.reshape(-1), yw_np.reshape(-1),
                np.concatenate([zc_np, yc_np]).view(np.uint16)]
            ).view(np.int16)
        up = device_rans.to_device_async(staged, self.device)
        n_wz, n_wy = zw_np.size, yw_np.size
        zw = up[:n_wz].view(zw_np.shape)
        yw = up[n_wz: n_wz + n_wy].view(yw_np.shape)
        counts = up[n_wz + n_wy:].view(torch.int32)

        with profiling.span("enqueue"):
            z_syms, z_cons, z_fin = cuda_rans.decode(
                zw, cuda_rans.split_init(zw, nl_z), self._z_lane_cdf(nl_z),
                t_z)
            z_vals = z_syms.to(torch.int32).reshape(b, zx, zy, zc) - _Z_MAX
            z_hat = _patch_escapes(z_vals, [m[3] for m in metas],
                                   _Z_MAX).to(torch.float32)

            mu, sigma = self._prior_from_z(z_hat)
            ctx_y = self._scale_ctx(sigma)
            y_syms, y_cons, y_fin = cuda_rans.decode_ctx(
                yw, cuda_rans.split_init(yw, nl_y), self._y_table(),
                ctx_y.reshape(b * s_y, t_y, nl_y).contiguous(), t_y)
            y_vals = y_syms.reshape(b, yx, yy, yc) - _Y_MAX_DEV
            y_hat = _patch_escapes(y_vals, [m[4] for m in metas],
                                   _Y_MAX_DEV).to(torch.float32)
            if mu is not None:
                y_hat = y_hat + mu
            x_hat = self.model.decode_arrays(y_hat)

            lb = ilrans.STATE_LB
            ok = torch.cat([(z_fin == lb).all(1), (y_fin == lb).all(1)]) & (
                torch.cat([z_cons, y_cons]) == counts)
            fetch = device_rans.to_host_async(ok)
        return x_hat, y_hat, z_hat, fetch, zc_np.size

    def _decompress_drain(self, state: Tuple
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """Wait for a scheduled batch's validity flags and check them."""
        x_hat, y_hat, z_hat, fetch, n_z = state
        ok = device_rans.host_array(fetch)
        if not ok[:n_z].all():
            raise ValueError("corrupt hyper-latent stream")
        if not ok[n_z:].all():
            raise ValueError("corrupt latent stream")
        return x_hat, y_hat, z_hat

    # --- host serial format ---------------------------------------------
    def compress(self, x: torch.Tensor) -> bytes:
        """One (1, X, Y, 3) [0, 1] image, X and Y multiples of 64 -> a
        ``CODEC_HYPERPRIOR`` container.  The transforms run on the device;
        scale bins and coding on the host."""
        if x.shape[0] != 1:
            raise ValueError("compress takes one image: use compress_batch")
        if x.shape[1] % 64 or x.shape[2] % 64:
            raise ValueError("hyperprior codecs need image sides divisible "
                             "by 64 (16x analysis, 4x hyper stage)")
        y, z, sigma = (a.cpu().numpy() for a in self.encode_parts(x))
        _, zx, zy, zc = z.shape
        z_ctx = np.broadcast_to(np.arange(zc, dtype=np.int32), (zx * zy, zc))
        z_bytes = _code(z.reshape(-1, zc), z_ctx, self.z_cdfs, _Z_MAX)
        idx = entropy.scale_to_index(sigma.ravel(), self.scale_table)
        y_bytes = _code(y.ravel(), idx, self.y_cdfs, _Y_MAX)
        header = struct.pack("<HHHHHH", x.shape[1], x.shape[2], zx, zy, zc,
                             y.shape[3])
        return container.pack(container.CODEC_HYPERPRIOR,
                              [header, z_bytes, y_bytes])

    def decompress(self, data: bytes) -> Tuple[torch.Tensor, torch.Tensor]:
        """A ``CODEC_HYPERPRIOR`` container -> (x_hat (1, X, Y, 3), y_hat
        (1, X/16, Y/16, M)) float32 on the device."""
        cid, sections = container.unpack(data)
        if cid != container.CODEC_HYPERPRIOR or len(sections) != 3:
            raise ValueError("not a serial hyperprior container")
        header, z_bytes, y_bytes = sections
        _, _, zx, zy, zc, _ = struct.unpack("<HHHHHH", header)
        z_ctx = np.broadcast_to(np.arange(zc, dtype=np.int32),
                                (zx * zy, zc)).ravel()
        z = _decode(z_bytes, zx * zy * zc, z_ctx, self.z_cdfs, _Z_MAX)
        z_hat = torch.from_numpy(z.reshape(1, zx, zy, zc).astype(
            np.float32)).to(self.device)
        mu, sigma = self._prior_from_z(z_hat)
        sigma = sigma.cpu().numpy()
        idx = entropy.scale_to_index(sigma.ravel(), self.scale_table)
        y = _decode(y_bytes, sigma.size, idx, self.y_cdfs, _Y_MAX)
        y_hat = torch.from_numpy(y.reshape(sigma.shape).astype(
            np.float32)).to(self.device)
        if mu is not None:
            y_hat = y_hat + mu
        return self.model.decode_arrays(y_hat), y_hat


class MeanScaleCodec(HyperCodec):
    """Codec for ``MeanScaleHyperprior``: the symbols are round(y - mu),
    zero-mean; the decoder adds mu back, in float32, before g_s.  The
    containers are the scale codec's formats: they carry no model id."""

    model_cls = MeanScaleHyperprior

    def _prior_from_z(self, z_hat: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        mu, sigma = zip(*_image_by_image(self.model.params_from_z, z_hat))
        return torch.cat(mu), torch.cat(sigma)
