"""End-to-end bitstream codec for the bit-exact integer model.

The counterpart of the JAX package's ``codec/int_codec.py``:

encode: images -> integer analysis transform (kernel A) -> int8 latent
        (values 0..127) -> N-lane interleaved rANS -> container bytes, one
        per image, byte-identical with the JAX package's
        ``compress_batch`` for the same coder and tables.
decode: container bytes -> rANS decode (exact latent) -> integer synthesis
        transform (kernel A) -> reconstruction, bit-exact with running the
        autoencoder directly.

Latent layout: (zx*zy, C) channel-fastest, split into S contiguous spatial
streams of t steps x N = lane_mult*C lanes; lane k codes channel k % C.
At 768x512 that is S = 8 streams, t = 96 steps, N = 384 lanes per image.

Coders (``coder``): "device" codes on the card (kernels B and C; on the
CPU their plain versions), "native" on the host C++ coder, "golden" on its
NumPy golden (``codec/rans.py``, ``codec/ilrans.py``); "auto" picks
"device" when the net lies on the card and "native" otherwise.  Without
``static_cdfs`` each container embeds its image's histogram tables
(``_serialize_cdfs``, 2*C*L bytes: 49,536 at C = 192).  Every coder writes
and reads them: the device coder counts the latent's symbols on the card,
fetches the counts once, and launches kernel B (or C) once an image, on that
image's tables.  The host path is one synchronous call.

On the device coder each direction is a schedule phase, which enqueues the
device work and an asynchronous copy of what the host needs, and a drain
phase, which waits for that copy alone and packs or checks
(``_compress_schedule`` / ``_compress_drain``, ``_decompress_schedule`` /
``_decompress_drain``): ``codec/pipeline.py`` overlaps one batch's drain
with the next one's device work, and each batch call is the drain of its
schedule.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.codec_int import IntCodecNet
from ..utils import profiling
from . import container, cuda_rans, device_rans, entropy, ilrans, rans

_MAX_SYM = 128  # latent values are post-ReLU int8: 0..127
_L = _MAX_SYM + 1  # + escape bucket (never used for in-range data)
CODERS = ("device", "native", "golden", "auto")
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


_LANE_TABLE_SLOTS = 8   # tables kept per (n_lanes, device)
_lane_tables: Dict[Tuple[int, torch.device],
                   List[Tuple[np.ndarray, torch.Tensor]]] = {}


def _lane_cdf_tensor(cdfs: np.ndarray, n_lanes: int, device) -> torch.Tensor:
    """The per-lane table on ``device``, uploaded once for each (n_lanes,
    device) and table contents, the last ``_LANE_TABLE_SLOTS`` of them
    kept: an upload from pageable host memory waits for the stream, and
    the kernels keep their layouts of this tensor
    (``cuda_rans.kernel_table``, ``encode_kernel_table``), so that codecs
    with different tables must not evict each other.  Each upload counts
    in ``_lane_cdf_tensor.misses``.  Callers must not write to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:     # "cuda" is "cuda:<current>"
        dev = torch.device("cuda", torch.cuda.current_device())
    slots = _lane_tables.setdefault((n_lanes, dev), [])
    for i, (held, table) in enumerate(slots):
        if held.shape == cdfs.shape and np.array_equal(held, cdfs):
            slots.insert(0, slots.pop(i))
            return table
    rows = np.ascontiguousarray(_lane_cdf(cdfs, n_lanes), np.int32)
    table = torch.from_numpy(rows).to(device)
    slots.insert(0, (np.array(cdfs, copy=True), table))
    del slots[_LANE_TABLE_SLOTS:]
    _lane_cdf_tensor.misses += 1
    return table


_lane_cdf_tensor.misses = 0


def _cdfs_from_counts(counts: np.ndarray) -> np.ndarray:
    """(C, 128) symbol counts of each channel -> quantized CDF rows
    (C, L+1)."""
    rows = []
    for row in counts.astype(np.float64):
        pmf = row / max(row.sum(), 1.0)
        rows.append(entropy.quantize_cdf(np.append(pmf, 0.0)))
    return np.stack(rows)


def _histogram_cdfs(z: np.ndarray) -> np.ndarray:
    """Per-channel histogram of int8 latents (..., C) -> quantized CDF rows
    (C, L+1)."""
    c = z.shape[-1]
    flat = z.reshape(-1, c)
    return _cdfs_from_counts(np.stack([
        np.bincount(flat[:, ch].astype(np.int64), minlength=_MAX_SYM)
        for ch in range(c)]))


def _device_cdfs(z: torch.Tensor) -> List[np.ndarray]:
    """(B, zx, zy, C) latents on their device -> each image's
    ``_histogram_cdfs``: one bincount on the device, one fetch of the
    (B, C, 128) counts, the tables fitted on the host."""
    b, c = z.shape[0], z.shape[-1]
    base = torch.arange(b * c, device=z.device).reshape(b, 1, c) * _MAX_SYM
    key = z.reshape(b, -1, c).to(torch.int64) + base
    counts = torch.bincount(key.reshape(-1), minlength=b * c * _MAX_SYM)
    with profiling.span("wait"):
        counts = counts.reshape(b, c, _MAX_SYM).cpu().numpy()
    if (counts.sum(2) != key.shape[1]).any():
        raise ValueError(f"latent values outside 0..{_MAX_SYM - 1}")
    return [_cdfs_from_counts(k) for k in counts]


def _image_lane_tables(cdfs: Sequence[np.ndarray], n_lanes: int,
                       device: torch.device) -> torch.Tensor:
    """Each image's (C, L+1) tables -> (B, N, L+1) int32 lane tables on
    ``device``, in one upload that does not wait for the stream."""
    return device_rans.to_device_async(np.stack(
        [_lane_cdf(cd, n_lanes) for cd in cdfs]).astype(np.int32), device)


def _serialize_cdfs(cdfs: np.ndarray) -> bytes:
    """(C, L+1) CDF rows -> their frequencies as little-endian u16, a
    frequency of 2^16 stored as 0 (unambiguous: ``quantize_cdf`` gives
    every symbol at least 1)."""
    return np.diff(cdfs, axis=1).astype(np.int64).astype("<u2").tobytes()


def _deserialize_cdfs(data: bytes, channels: int) -> np.ndarray:
    if len(data) != 2 * channels * _L:
        raise ValueError(f"{len(data)} bytes of tables for {channels} "
                         f"channels of {_L} symbols")
    freqs = np.frombuffer(data, "<u2").astype(np.int64).reshape(channels, _L)
    freqs[freqs == 0] = 1 << 16
    cdfs = np.zeros((channels, _L + 1), np.int64)
    cdfs[:, 1:] = np.cumsum(freqs, axis=1)
    if not (cdfs[:, -1] == 1 << ilrans.PREC).all():
        raise ValueError("table rows do not sum to 2^16")
    return cdfs.astype(np.int32)


def build_static_cdfs(net: IntCodecNet, images) -> np.ndarray:
    """Fit per-channel latent CDFs on sample images (each a (B, X, Y, 3)
    uint8/int8 batch), shipped with the model so that containers carry no
    tables."""
    zs = [net.analysis(torch.as_tensor(x)).cpu().numpy() for x in images]
    z = np.concatenate([a.reshape(-1, a.shape[-1]) for a in zs], axis=0)
    return _histogram_cdfs(z[None])


def _pick_coder(coder: str, net: IntCodecNet) -> str:
    if coder not in CODERS:
        raise ValueError(f"unknown coder {coder!r}: one of {CODERS}")
    if coder != "auto":
        return coder
    return "device" if net.device.type == "cuda" else "native"


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
    """x: (B, X, Y, 3) uint8/int8 wire images -> B container bytestrings,
    each embedding its image's histogram tables where ``static_cdfs`` is
    None.

    The transform runs on ``net.device``.  On the device coder: the
    encode on kernel B, then one fetch of the counts and one of the words
    (bucketed to the longest stream), ``_compress_drain`` of
    ``_compress_schedule``.  On the host coders the latent is fetched and
    each image's streams are coded on the host."""
    coder = _pick_coder(coder, net)
    if coder == "device":
        return _compress_drain(_compress_schedule(net, x, static_cdfs, 0,
                                                  lane_mult, n_streams))[0]
    return _compress_host(net, x, static_cdfs, coder != "golden",
                          lane_mult, n_streams)


def _compress_host(net: IntCodecNet, x: torch.Tensor,
                   static_cdfs: np.ndarray | None, use_native: bool,
                   lane_mult: int, n_streams: int) -> List[bytes]:
    """The host coders' encode: the batched transform, one fetch of the
    latent, then each image's S streams on the native coder or its
    golden."""
    z = net.analysis(x).cpu().numpy()
    b, zx, zy, c = z.shape
    s, lane_mult = plan_streams(zx * zy, lane_mult, n_streams)
    n_lanes = lane_mult * c
    t_steps = (zx * zy) // lane_mult // s
    header = struct.pack("<HHHHH", x.shape[1], x.shape[2], zx, zy, c)
    ctx = np.broadcast_to(np.arange(c, dtype=np.int32),
                          (t_steps * lane_mult, c)).ravel()
    out = []
    for i in range(b):
        cdfs = _histogram_cdfs(z[i]) if static_cdfs is None else static_cdfs
        syms = z[i].reshape(s, -1).astype(np.int32)
        chunks = [rans.encode_interleaved(syms[j], ctx, cdfs,
                                          n_lanes=n_lanes,
                                          use_native=use_native)
                  for j in range(s)]
        out.append(container.pack(container.CODEC_INT8, [
            header, b"" if static_cdfs is not None else _serialize_cdfs(cdfs),
            _pack_streams(chunks)]))
    return out


def _compress_schedule(net: IntCodecNet, x: torch.Tensor,
                       static_cdfs: np.ndarray | None, mxb: int | None,
                       lane_mult: int = DEFAULT_LANE_MULT,
                       n_streams: int = DEFAULT_STREAMS) -> Tuple:
    """Enqueue one batch's analysis (kernel A) and encode (kernel B), then
    ONE copy to pinned host memory of the counts and the words' first
    ``mxb`` columns (None: every column; 0: the counts alone), with an
    event after it.  Returns the state that ``_compress_drain`` packs, so
    that a pipeline packs batch k while batch k+1 runs
    (``pipeline.PipelinedEncoder``).  With ``static_cdfs`` nothing waits
    for the device; without, the schedule waits for the latent's symbol
    counts (``_device_cdfs``) and launches kernel B once an image, on that
    image's tables.

    Kernel B writes into buffers sized for one word a symbol, so no stream
    outgrows them: the JAX package's re-encode on its scan engine has no
    counterpart here."""
    with profiling.span("enqueue"):
        z = net.analysis(x)
        b, zx, zy, c = z.shape
        s, lane_mult = plan_streams(zx * zy, lane_mult, n_streams)
        n_lanes = lane_mult * c
        t_steps = (zx * zy) // lane_mult // s
        syms = z.reshape(b * s, t_steps, n_lanes)
        if static_cdfs is not None:
            sections = [b""] * b
            words, counts = cuda_rans.encode_batch_compact(
                syms, _lane_cdf_tensor(static_cdfs, n_lanes, z.device))
        else:
            cdfs = _device_cdfs(z)
            sections = [_serialize_cdfs(cd) for cd in cdfs]
            lanes = _image_lane_tables(cdfs, n_lanes, z.device)
            outs = [cuda_rans.encode_batch_compact(syms[i * s:(i + 1) * s],
                                                   lanes[i])
                    for i in range(b)]
            words, counts = (torch.cat(o) for o in zip(*outs))
        w = words.shape[1] if mxb is None else min(mxb, words.shape[1])
        fetch = device_rans.to_host_async(torch.cat([
            words[:, :w].reshape(-1), counts.view(torch.int16)]))
    header = struct.pack("<HHHHH", x.shape[1], x.shape[2], zx, zy, c)
    return words, fetch, w, s, t_steps * n_lanes, n_lanes, header, sections


def _compress_drain(state: Tuple) -> Tuple[List[bytes], int]:
    """Wait for a scheduled batch's copy and pack its containers -> (B
    containers, the bucketed width its longest stream needed).  Words cut
    narrower than that need are fetched again, blocking."""
    words, fetch, w, s, n_syms, n_lanes, header, sections = state
    buf = device_rans.host_array(fetch)
    n_str = len(sections) * s
    counts_np = buf[n_str * w:].view(np.int32)
    flat_w, need = device_rans.words_at_need(
        words, buf[:n_str * w].view(np.uint16).reshape(n_str, w), counts_np)
    with profiling.span("pack"):
        chunks = device_rans.streams_from_words(flat_w, counts_np, n_syms,
                                                n_lanes)
        return [container.pack(container.CODEC_INT8,
                               [header, tables,
                                _pack_streams(chunks[i * s:(i + 1) * s])])
                for i, tables in enumerate(sections)], need


def _parse(streams: Sequence[bytes]) -> List[Tuple]:
    """Containers -> [(header fields, table bytes, S stream chunks)], all
    of one geometry, with a stream plan that covers the latent."""
    with profiling.span("parse"):
        metas = []
        for data in streams:
            codec_id, sections = container.unpack(data)
            if codec_id != container.CODEC_INT8 or len(sections) != 3:
                raise ValueError("not an int8 codec container")
            header, cdf_bytes, payload = sections
            metas.append((struct.unpack("<HHHHH", header), cdf_bytes,
                          _unpack_streams(payload)))
        (_, _, zx, zy, c) = metas[0][0]
        if any(m[0] != metas[0][0] for m in metas):
            raise ValueError("mixed geometries in one batch")
        s = len(metas[0][2])
        n_syms = ilrans.unpack_header(metas[0][2][0])[0]
        if any(len(m[2]) != s for m in metas) or n_syms * s != zx * zy * c:
            raise ValueError("stream plan does not cover the latent")
    return metas


def decompress_batch(net: IntCodecNet, streams: Sequence[bytes],
                     static_cdfs: np.ndarray | None = None,
                     coder: str = "device"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B containers -> (reconstructions (B, X, Y, 3) int8, latents int8),
    both on ``net.device``.  All containers must share one geometry.
    Raises ValueError for a corrupt stream (words consumed != stream
    length, or a final coder state != 2^16): on the device coder
    ``_decompress_drain`` of ``_decompress_schedule``."""
    coder = _pick_coder(coder, net)
    metas = _parse(streams)
    if coder == "device":
        return _decompress_drain(_decompress_schedule(net, metas,
                                                      static_cdfs))
    return _decompress_host(net, metas, static_cdfs, coder != "golden")


def _tables_of(meta: Tuple, static_cdfs: np.ndarray | None) -> np.ndarray:
    c = meta[0][4]
    if meta[1]:
        return _deserialize_cdfs(meta[1], c)
    if static_cdfs is None:
        raise ValueError("the container needs the model's static tables")
    return static_cdfs


def _decompress_host(net: IntCodecNet, metas: List[Tuple],
                     static_cdfs: np.ndarray | None, use_native: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host coders' decode, image by image, then one upload of the
    latents and the batched synthesis."""
    (_, _, zx, zy, c) = metas[0][0]
    ctx = np.broadcast_to(np.arange(c, dtype=np.int32),
                          (zx * zy // len(metas[0][2]), c)).ravel()
    zs = []
    for m in metas:
        cdfs = _tables_of(m, static_cdfs)
        zs.append(np.concatenate([
            rans.decode_interleaved(chunk, ctx, cdfs, use_native=use_native)
            for chunk in m[2]]).reshape(zx, zy, c).astype(np.int8))
    z = torch.from_numpy(np.stack(zs)).to(net.device)
    return net.synthesis(z), z


def _upload_streams(chunks: Sequence[bytes], dev: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ilrans streams -> ((S, cap) int16 words past each header, (S,)
    int32 word counts) on ``dev``, in one pinned upload that does not wait
    for the stream: the words first (16-byte aligned for the kernel), the
    counts after."""
    with profiling.span("stage"):
        words, true_counts = device_rans.gather_words(chunks)
        staged = np.concatenate([
            words.reshape(-1), true_counts.view(np.uint16)]).view(np.int16)
    up = device_rans.to_device_async(staged, dev)
    return (up[:words.size].view(words.shape),
            up[words.size:].view(torch.int32))


def _decompress_schedule(net: IntCodecNet, metas: List[Tuple],
                         static_cdfs: np.ndarray | None) -> Tuple:
    """Upload the words and counts of parsed containers (``_parse``) in
    one pinned copy without waiting, and enqueue the decode (kernel C: once
    for the batch on the static tables, once an image where the containers
    carry tables), the synthesis (kernel A) and the copy of each stream's
    validity flag to pinned host memory, with an event after it."""
    (_, _, zx, zy, c) = metas[0][0]
    b, s = len(metas), len(metas[0][2])
    n_syms, n_lanes, _, _ = ilrans.unpack_header(metas[0][2][0])
    t_steps = n_syms // n_lanes

    dev = net.device
    wdev, counts = _upload_streams([chunk for m in metas for chunk in m[2]],
                                   dev)
    if any(m[1] for m in metas):
        lanes = _image_lane_tables(
            [_tables_of(m, static_cdfs) for m in metas], n_lanes, dev)
        parts = [(wdev[i * s:(i + 1) * s], lanes[i]) for i in range(b)]
    else:
        parts = [(wdev, _lane_cdf_tensor(_tables_of(metas[0], static_cdfs),
                                         n_lanes, dev))]
    with profiling.span("enqueue"):
        outs = [cuda_rans.decode(w, cuda_rans.split_init(w, n_lanes), tb,
                                 t_steps) for w, tb in parts]
        syms, consumed, x_fin = (outs[0] if len(outs) == 1 else
                                 (torch.cat(o) for o in zip(*outs)))
        z = syms.reshape(b, zx, zy, c)
        x_hat = net.synthesis(z)
        ok = (consumed == counts) & (x_fin == ilrans.STATE_LB).all(1)
        fetch = device_rans.to_host_async(ok)
    return x_hat, z, fetch, s


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
