"""End-to-end bitstream codec for the bit-exact integer model, on the card.

The counterpart of the JAX package's ``codec/int_codec.py`` with the device
coder and static CDFs:

encode: images -> integer analysis transform (kernel A) -> int8 latent
        (values 0..127) -> N-lane interleaved rANS on the card (kernel B)
        -> container bytes, one per image, byte-identical with the JAX
        package's ``compress_batch(coder="device", static_cdfs=...)``.
decode: container bytes -> rANS decode on the card (kernel C, exact latent)
        -> integer synthesis transform (kernel A) -> reconstruction,
        bit-exact with running the autoencoder directly.

Latent layout: (zx*zy, C) channel-fastest, split into S contiguous spatial
streams of t steps x N = lane_mult*C lanes; lane k codes channel k % C.
At 768x512 that is S = 8 streams, t = 96 steps, N = 384 lanes per image.

Each direction is a schedule phase, which enqueues the device work and an
asynchronous copy of what the host needs, and a drain phase, which waits
for that copy alone and packs or checks (``_compress_schedule`` /
``_compress_drain``, ``_decompress_schedule`` / ``_decompress_drain``):
``codec/pipeline.py`` overlaps one batch's drain with the next one's
device work, and each batch call is the drain of its schedule.

Not ported yet (``NotImplementedError``): per-image histogram tables
(``static_cdfs=None``) and the host coders (``coder`` other than "device").
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.codec_int import IntCodecNet
from . import container, cuda_rans, device_rans, ilrans

DEFAULT_LANE_MULT = 2   # lanes = mult * channels
DEFAULT_STREAMS = 8     # independent spatial streams per image


def plan_streams(n_pix: int, lane_mult: int = DEFAULT_LANE_MULT,
                 n_streams: int = DEFAULT_STREAMS) -> Tuple[int, int]:
    """Pick (S, lane_mult) dividing the zx*zy latent pixels evenly, with
    >= 32 steps per stream (same rule as the JAX package; the choice is
    recorded in the bitstream)."""
    while n_pix % lane_mult:
        lane_mult -= 1
    t_total = n_pix // lane_mult
    s = max(1, min(n_streams, t_total // 32))
    while t_total % s:
        s -= 1
    return s, lane_mult


def _lane_cdf(cdfs: np.ndarray, n_lanes: int) -> np.ndarray:
    """(C, L+1) context CDFs -> per-lane rows (lane k <-> channel k % C)."""
    c = cdfs.shape[0]
    return cdfs[np.arange(n_lanes) % c]


_lane_tables: Dict[Tuple[int, torch.device], Tuple[np.ndarray,
                                                  torch.Tensor]] = {}


def _lane_cdf_tensor(cdfs: np.ndarray, n_lanes: int, device) -> torch.Tensor:
    """The per-lane table on ``device``, uploaded once per (n_lanes,
    device) while ``cdfs`` keeps its values: an upload from pageable host
    memory waits for the stream, and the decoder keeps its staged layout
    of this tensor (``cuda_rans.kernel_table``).  Callers must not write
    to it."""
    key = (n_lanes, torch.device(device))
    hit = _lane_tables.get(key)
    if hit is not None and hit[0].shape == cdfs.shape and np.array_equal(
            hit[0], cdfs):
        return hit[1]
    rows = np.ascontiguousarray(_lane_cdf(cdfs, n_lanes), np.int32)
    table = torch.from_numpy(rows).to(device)
    _lane_tables[key] = (np.array(cdfs, copy=True), table)
    return table


def _require_device_coder(coder: str, static_cdfs) -> None:
    if coder != "device":
        raise NotImplementedError(
            f"coder={coder!r}: only the device coder is ported")
    if static_cdfs is None:
        raise NotImplementedError(
            "per-image histogram tables are not ported: pass static_cdfs")


def _pack_streams(streams: Sequence[bytes]) -> bytes:
    """S per-chunk ilrans streams -> one payload section."""
    return struct.pack("<H", len(streams)) + b"".join(
        struct.pack("<I", len(s)) + s for s in streams)


def _unpack_streams(payload: bytes) -> List[bytes]:
    (s,) = struct.unpack_from("<H", payload)
    out, off = [], 2
    for _ in range(s):
        (ln,) = struct.unpack_from("<I", payload, off)
        out.append(payload[off + 4: off + 4 + ln])
        off += 4 + ln
    return out


def compress_batch(net: IntCodecNet, x: torch.Tensor,
                   static_cdfs: np.ndarray | None = None,
                   coder: str = "device",
                   lane_mult: int = DEFAULT_LANE_MULT,
                   n_streams: int = DEFAULT_STREAMS) -> List[bytes]:
    """x: (B, X, Y, 3) uint8/int8 wire images -> B container bytestrings.

    Runs on ``net.device``: one batched transform and one batched entropy
    encode over all B*S streams, then one fetch of the counts and one of
    the words (bucketed to the longest stream): ``_compress_drain`` of
    ``_compress_schedule``."""
    _require_device_coder(coder, static_cdfs)
    return _compress_drain(_compress_schedule(net, x, static_cdfs, 0,
                                              lane_mult, n_streams))[0]


def _compress_schedule(net: IntCodecNet, x: torch.Tensor,
                       static_cdfs: np.ndarray, mxb: int | None,
                       lane_mult: int = DEFAULT_LANE_MULT,
                       n_streams: int = DEFAULT_STREAMS) -> Tuple:
    """Enqueue one batch's analysis (kernel A) and encode (kernel B), then
    ONE copy to pinned host memory of the counts and the words' first
    ``mxb`` columns (None: every column; 0: the counts alone), with an
    event after it; no wait on the device.  Returns the state that
    ``_compress_drain`` packs, so that a pipeline packs batch k while
    batch k+1 runs (``pipeline.PipelinedEncoder``).

    Kernel B writes into buffers sized for one word a symbol, so no stream
    outgrows them: the JAX package's re-encode on its scan engine has no
    counterpart here."""
    z = net.analysis(x)
    b, zx, zy, c = z.shape
    s, lane_mult = plan_streams(zx * zy, lane_mult, n_streams)
    n_lanes = lane_mult * c
    t_steps = (zx * zy) // lane_mult // s
    lane_cdf = _lane_cdf_tensor(static_cdfs, n_lanes, z.device)
    words, counts = cuda_rans.encode_batch_compact(
        z.reshape(b * s, t_steps, n_lanes), lane_cdf)
    w = words.shape[1] if mxb is None else min(mxb, words.shape[1])
    fetch = device_rans.to_host_async(torch.cat([
        words[:, :w].reshape(-1), counts.view(torch.int16)]))
    header = struct.pack("<HHHHH", x.shape[1], x.shape[2], zx, zy, c)
    return words, fetch, w, b, s, t_steps * n_lanes, n_lanes, header


def _compress_drain(state: Tuple) -> Tuple[List[bytes], int]:
    """Wait for a scheduled batch's copy and pack its containers -> (B
    containers, the bucketed width its longest stream needed).  Words cut
    narrower than that need are fetched again, blocking."""
    words, fetch, w, b, s, n_syms, n_lanes, header = state
    buf = device_rans.host_array(fetch)
    n_str = b * s
    counts_np = buf[n_str * w:].view(np.int32)
    flat_w, need = device_rans.words_at_need(
        words, buf[:n_str * w].view(np.uint16).reshape(n_str, w), counts_np)
    chunks = device_rans.streams_from_words(flat_w, counts_np, n_syms,
                                            n_lanes)
    return [container.pack(container.CODEC_INT8,
                           [header, b"", _pack_streams(chunks[i * s:
                                                              (i + 1) * s])])
            for i in range(b)], need


def decompress_batch(net: IntCodecNet, streams: Sequence[bytes],
                     static_cdfs: np.ndarray | None = None,
                     coder: str = "device"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B containers -> (reconstructions (B, X, Y, 3) int8, latents int8),
    both on ``net.device``.  All containers must share one geometry.
    Raises ValueError for a corrupt stream (words consumed != stream
    length, or a final coder state != 2^16): ``_decompress_drain`` of
    ``_decompress_schedule``."""
    _require_device_coder(coder, static_cdfs)
    return _decompress_drain(_decompress_schedule(net, streams, static_cdfs))


def _decompress_schedule(net: IntCodecNet, streams: Sequence[bytes],
                         static_cdfs: np.ndarray) -> Tuple:
    """Parse the containers on the host, upload words and counts in one
    pinned copy without waiting, and enqueue the decode (kernel C), the
    synthesis (kernel A) and the copy of each stream's validity flag to
    pinned host memory, with an event after it."""
    metas = []
    for data in streams:
        codec_id, sections = container.unpack(data)
        if codec_id != container.CODEC_INT8 or len(sections) != 3:
            raise ValueError("not an int8 codec container")
        header, cdf_bytes, payload = sections
        if cdf_bytes:
            raise NotImplementedError(
                "container embeds per-image tables: not ported")
        metas.append((struct.unpack("<HHHHH", header),
                      _unpack_streams(payload)))
    (_, _, zx, zy, c) = metas[0][0]
    if any(m[0] != metas[0][0] for m in metas):
        raise ValueError("mixed geometries in one batch")
    s = len(metas[0][1])
    n_syms, n_lanes, _, _ = ilrans.unpack_header(metas[0][1][0])
    if n_syms * s != zx * zy * c:
        raise ValueError("stream plan does not cover the latent")
    t_steps = n_syms // n_lanes

    words, true_counts = device_rans.gather_words(
        [chunk for m in metas for chunk in m[1]])
    dev = net.device
    # words first (16-byte aligned for the kernel), the counts after
    up = device_rans.to_device_async(np.concatenate([
        words.reshape(-1), true_counts.view(np.uint16)]).view(np.int16), dev)
    wdev = up[:words.size].view(words.shape)
    counts = up[words.size:].view(torch.int32)
    lane_cdf = _lane_cdf_tensor(static_cdfs, n_lanes, dev)
    syms, consumed, x_fin = cuda_rans.decode(
        wdev, cuda_rans.split_init(wdev, n_lanes), lane_cdf, t_steps)
    z = syms.reshape(len(streams), zx, zy, c)
    x_hat = net.synthesis(z)
    ok = (consumed == counts) & (x_fin == ilrans.STATE_LB).all(1)
    return x_hat, z, device_rans.to_host_async(ok), s


def _decompress_drain(state: Tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wait for a scheduled batch's validity flags and check them."""
    x_hat, z, fetch, s = state
    ok = device_rans.host_array(fetch)
    if not ok.all():
        bad = int(np.flatnonzero(~ok)[0])
        raise ValueError(f"corrupt stream (image {bad // s}, chunk {bad % s})")
    return x_hat, z


def compress(net: IntCodecNet, x: torch.Tensor,
             static_cdfs: np.ndarray | None = None,
             coder: str = "device") -> bytes:
    """Single-image wrapper around ``compress_batch``."""
    if x.shape[0] != 1:
        raise ValueError("use compress_batch for B > 1")
    return compress_batch(net, x, static_cdfs, coder)[0]


def decompress(net: IntCodecNet, data: bytes,
               static_cdfs: np.ndarray | None = None,
               coder: str = "device") -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-image wrapper around ``decompress_batch``."""
    return decompress_batch(net, [data], static_cdfs, coder)


def compression_stats(x_shape, data: bytes) -> Dict[str, float]:
    n_pixels = x_shape[1] * x_shape[2]
    raw_bytes = n_pixels * x_shape[3]
    return {
        "bytes": len(data),
        "bpp": 8.0 * len(data) / n_pixels,
        "ratio": raw_bytes / len(data),
    }
