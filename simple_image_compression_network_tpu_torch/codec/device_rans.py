"""Interleaved rANS as plain, lane-vectorized PyTorch, and the host helpers
between stream bytes and word buffers.

The counterpart of the JAX package's ``codec/device_rans.py``.  ``encode``
and ``decode`` here are the plain versions of kernels B and C, and with a
context tensor of kernels D and E (``codec/cuda_rans.py``): every stream
and every lane advances at once, one step of the serial loop per Python
iteration.  They run on any device.

torch has no ``>>``, ``//`` or ``+`` for ``uint32`` on the CPU, so 32-bit
states are held in int64 and masked to 32 bits where a u32 would wrap.
Word buffers hold u16 values; any integer dtype is accepted on input
(int16 buffers carry the u16 bit patterns).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from . import ilrans

_U16 = 0xFFFF
_U32 = 0xFFFFFFFF


def _lane_rows(lane_cdf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """lane_cdf[lane, idx[..., lane]] for idx (..., N)."""
    n = lane_cdf.shape[0]
    lanes = torch.arange(n, device=idx.device)
    return lane_cdf[lanes.expand_as(idx), idx]


def _lookup(cdf: torch.Tensor, ctx, idx: torch.Tensor) -> torch.Tensor:
    """CDF entry idx of each symbol's row: the lane's own row of an
    (N, L+1) table (ctx None), else row ctx of a shared (R, L+1) table."""
    return _lane_rows(cdf, idx) if ctx is None else cdf[ctx, idx]


def encode(syms: torch.Tensor, cdf: torch.Tensor,
           ctx: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode S streams: syms (S, t, N) -> (words (S, 2N + t*N) int64
    holding u16 values, counts (S,) int64).

    cdf: (N, L+1) CDF row of each lane (precision 16), or with ctx
    (S, t, N) row indices a shared (R, L+1) table whose row ctx[s, t, k]
    codes symbol syms[s, t, k].  words[s, :counts[s]] is stream s past its
    8-byte header, bit-identical with the JAX package's
    ``device_rans.encode`` and ``ilrans.encode``."""
    return assemble_stream(*encode_dense(syms, cdf, ctx))


def encode_dense(syms: torch.Tensor, cdf: torch.Tensor,
                 ctx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse state loop of ``encode`` alone: (emits (S, t, N) int64,
    the candidate word x & 0xFFFF of every step; needs (S, t, N) bool,
    whether that word is emitted; x_fin (S, N) int64 final states)."""
    s, t_steps, n = syms.shape
    cdf = cdf.to(torch.int64)
    sy = syms.to(torch.int64)
    ctx = None if ctx is None else ctx.to(torch.int64)
    starts = _lookup(cdf, ctx, sy)
    freqs = _lookup(cdf, ctx, sy + 1) - starts
    x = torch.full((s, n), ilrans.STATE_LB, dtype=torch.int64,
                   device=syms.device)
    emits = torch.empty((s, t_steps, n), dtype=torch.int64,
                        device=syms.device)
    needs = torch.empty((s, t_steps, n), dtype=torch.bool,
                        device=syms.device)
    for t in range(t_steps - 1, -1, -1):
        freq = freqs[:, t]
        need = (x >> 16) >= freq
        emits[:, t] = x & _U16
        needs[:, t] = need
        x = torch.where(need, x >> 16, x)
        x = ((x // freq) << ilrans.PREC) + x % freq + starts[:, t]
    return emits, needs, x


def assemble_stream(emits: torch.Tensor, needs: torch.Tensor,
                    x_fin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, t, N) emitted words + flags + (S, N) final states -> (words
    (S, 2N + t*N), counts (S,)): the flush header (hi, lo per lane), then
    the emitted words in (t asc, lane asc) order; zeros past the count."""
    s, t_steps, n = emits.shape
    flags = needs.reshape(s, t_steps * n)
    fl = flags.to(torch.int64)
    pos = 2 * n + torch.cumsum(fl, dim=1) - fl
    buf = torch.zeros((s, 2 * n + t_steps * n), dtype=torch.int64,
                      device=emits.device)
    rows = torch.arange(s, device=emits.device)[:, None].expand_as(pos)
    buf[rows[flags], pos[flags]] = emits.reshape(s, -1)[flags]
    buf[:, 0:2 * n:2] = x_fin >> 16
    buf[:, 1:2 * n:2] = x_fin & _U16
    return buf, 2 * n + fl.sum(dim=1)


def select_words(words: torch.Tensor, pos: torch.Tensor, rank: torch.Tensor
                 ) -> torch.Tensor:
    """Renorm word distribution: w[s, l] = words[s, pos[s] + rank[s, l]],
    0 past the buffer's end (a corrupt stream then fails its final check
    instead of reading out of bounds)."""
    cap = words.shape[1]
    idx = pos[:, None] + rank
    got = torch.gather(words, 1, idx.clamp(max=cap - 1))
    return torch.where(idx < cap, got, torch.zeros_like(got))


def decode(words: torch.Tensor, x0: torch.Tensor, cdf: torch.Tensor,
           t_steps: int, ctx: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode S streams: words (S, cap) u16 values (the 2N flush words
    first), x0 (S, N) initial states -> (syms (S, t, N) int64, consumed
    (S,) int64, x_fin (S, N) int64).  cdf and ctx as in ``encode``.  A
    stream is valid iff consumed equals its word count and every final
    state equals 2^16."""
    s, cap = words.shape
    n = x0.shape[1]
    w = words.to(torch.int64) & _U16
    x = x0.to(torch.int64) & _U32
    cdf = cdf.to(torch.int64)
    ctx = None if ctx is None else ctx.to(torch.int64)
    inner = cdf[:, 1:-1]                               # (N or R, L-1)
    pos = torch.full((s,), 2 * n, dtype=torch.int64, device=words.device)
    syms = torch.empty((s, t_steps, n), dtype=torch.int64,
                       device=words.device)
    for t in range(t_steps):
        slot = x & _U16
        ctx_t = None if ctx is None else ctx[:, t]
        rows = inner[None] if ctx is None else inner[ctx_t]
        sym = (rows <= slot[..., None]).sum(dim=-1)
        start = _lookup(cdf, ctx_t, sym)
        freq = _lookup(cdf, ctx_t, sym + 1) - start
        x = (freq * (x >> ilrans.PREC) + slot - start) & _U32
        need = x < ilrans.STATE_LB
        ni = need.to(torch.int64)
        rank = torch.cumsum(ni, dim=1) - ni
        x = torch.where(need, (x << 16) | select_words(w, pos, rank), x)
        pos = pos + ni.sum(dim=1)
        syms[:, t] = sym
    return syms, pos, x


# ---------------------------------------------------------------------------
# Host-side helpers bridging bytes <-> word buffers
# ---------------------------------------------------------------------------

WORD_BUCKET = 4096  # words; buffer lengths round up to this


def bucket_words(n: int) -> int:
    return -(-n // WORD_BUCKET) * WORD_BUCKET


def words_from_bytes(data: bytes, cap: int) -> np.ndarray:
    """Stream bytes (past the ilrans header) -> u16 words, zero-padded to
    ``cap`` (which must cover the stream's word count)."""
    w = np.frombuffer(data, "<u2")
    out = np.zeros(cap, np.uint16)
    out[: w.size] = w
    return out


def fetch_words(words: torch.Tensor, counts: np.ndarray) -> np.ndarray:
    """(S, width) int16 device words -> host u16 words, cut to the longest
    stream's count rounded up to the bucket."""
    need = min(bucket_words(int(counts.max())), words.shape[1])
    return words[:, :need].cpu().numpy().view(np.uint16)


def words_at_need(words: torch.Tensor, got: np.ndarray, counts: np.ndarray
                  ) -> Tuple[np.ndarray, int]:
    """(host words, the bucketed width the longest stream needs) for words
    copied at a predicted width: ``got`` itself, or where that width falls
    short of the need, the words fetched again (blocking)."""
    need = min(bucket_words(int(counts.max())), words.shape[1])
    if need > got.shape[1]:
        with profiling.span("wait", refetches=1):
            got = fetch_words(words, counts)
    return got, need


def to_host_async(t: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start copying a CUDA tensor into pinned host memory on the current
    stream and record an event after the copy; the host tensor may be read
    once ``host_array`` has waited on that event.  Each call takes a pinned
    buffer of its own, which the caller holds until it has read it.  On the
    CPU: (``t``, None)."""
    if t.device.type != "cuda":
        return t, None
    with profiling.span("pin", pinned_bytes=t.nbytes):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def host_array(fetched: Tuple[torch.Tensor, Optional[torch.cuda.Event]]
               ) -> np.ndarray:
    """The numpy view of a ``to_host_async`` copy, after waiting on its
    event (that copy alone, not the stream's later work)."""
    host, done = fetched
    with profiling.span("wait"):
        if done is not None:
            done.synchronize()
    return host.numpy()


def to_device_async(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array through pinned memory without waiting for the
    stream (the pinned copy stays allocated until the upload has run).  On
    the CPU: the array as a tensor."""
    with profiling.span("upload"):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t
        with profiling.span("pin", pinned_bytes=t.nbytes):
            t = t.pin_memory()
        return t.to(device, non_blocking=True)


def gather_words(chunks: list) -> Tuple[np.ndarray, np.ndarray]:
    """S ilrans streams -> ((S, cap) u16 words past each header, zero-
    padded to a bucketed cap; (S,) int32 word counts)."""
    off = ilrans.unpack_header(chunks[0])[3]
    counts = np.asarray([(len(ch) - off) // 2 for ch in chunks], np.int32)
    cap = bucket_words(int(counts.max()))
    return (np.stack([words_from_bytes(ch[off:], cap) for ch in chunks]),
            counts)


def bytes_from_words(words: np.ndarray, count: int, n_syms: int,
                     n_lanes: int, prec: int = ilrans.PREC) -> bytes:
    """One stream's device encode output -> ilrans stream bytes (header +
    words[:count])."""
    return (ilrans.pack_header(n_syms, n_lanes, prec)
            + np.ascontiguousarray(words[:count]).astype(
                "<u2", copy=False).tobytes())


def streams_from_words(words: np.ndarray, counts: np.ndarray, n_syms: int,
                       n_lanes: int, prec: int = ilrans.PREC) -> list:
    """(S, cap) u16 words + (S,) counts -> S ilrans streams (header +
    words[:count])."""
    hdr = ilrans.pack_header(n_syms, n_lanes, prec)
    w2 = np.ascontiguousarray(words).astype("<u2", copy=False)
    mv = memoryview(w2).cast("B")
    row = w2.shape[1] * 2
    return [hdr + bytes(mv[i * row: i * row + 2 * int(counts[i])])
            for i in range(w2.shape[0])]


def decode_bytes(data: bytes, cdf: np.ndarray, ctx: Optional[np.ndarray],
                 device=None) -> np.ndarray:
    """Host API: one whole ilrans stream (header + words) -> its (n,) int32
    symbols, decoded on ``device`` (the card unless the caller asks for the
    CPU): with ``ctx`` None, ``cdf`` is the (N, L+1) table of the lanes and
    kernel C decodes; else ``cdf`` is a shared (R, L+1) table, ``ctx`` the
    (n,) row of each symbol, and kernel E decodes.  On the CPU the kernels'
    plain versions run.  Raises ValueError for a corrupt stream."""
    from ..utils.device import resolve_device
    from . import cuda_rans
    dev = resolve_device(device)
    n, n_lanes, prec, off = ilrans.unpack_header(data)
    if n == 0:
        return np.zeros(0, np.int32)
    if prec != ilrans.PREC:
        raise ValueError(f"the device decoders take precision {ilrans.PREC}, "
                         f"not {prec}")
    table = np.ascontiguousarray(cdf, np.int32)
    if ctx is None and table.shape[1] > 257:
        raise ValueError("kernel C stores u8 symbols: at most 256 a row")
    t_steps = -(-n // n_lanes)
    true_words = (len(data) - off) // 2
    words = words_from_bytes(data[off:off + 2 * true_words],
                             bucket_words(max(true_words, 2 * n_lanes)))
    w = torch.from_numpy(words.view(np.int16)[None]).to(dev)
    x0 = cuda_rans.split_init(w, n_lanes)
    tb = torch.from_numpy(table).to(dev)
    if ctx is None:
        syms, consumed, x_fin = cuda_rans.decode(w, x0, tb, t_steps)
        syms = syms.to(torch.int32) & 0xFF
    else:
        c = np.asarray(ctx, np.int32).ravel()
        if c.size < n:
            raise ValueError("fewer contexts than symbols")
        c = ilrans.pad_ctx(c[:n], n_lanes)
        c = torch.from_numpy(c.reshape(1, t_steps, n_lanes)).to(dev)
        syms, consumed, x_fin = cuda_rans.decode_ctx(w, x0, tb, c, t_steps)
    if int(consumed[0]) != true_words or not bool(
            (x_fin == ilrans.STATE_LB).all()):
        raise ValueError("corrupt ilrans stream (device decode)")
    return syms.reshape(-1)[:n].cpu().numpy().astype(np.int32)
