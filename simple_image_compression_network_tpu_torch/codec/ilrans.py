"""Interleaved N-lane rANS: the stream format and its NumPy golden coder.

The port's own copy of the JAX package's ``codec/ilrans.py``: N coder
states share ONE 16-bit word stream; symbol j is coded by lane j % N at
step j // N; 32-bit states live in [2^16, 2^32) and renormalize by at most
one word per symbol, so a (2N + n)-word buffer never overflows.  A stream
is an 8-byte header followed by the little-endian u16 words: the final
state of every lane as (hi, lo), then the renormalization words in decode
order.  The symbol count is padded up to a multiple of N by repeating the
final (symbol, context); decoders truncate.

``encode``/``decode`` here are the golden, vectorized over lanes in NumPy;
the native coder (``codec/rans.py``) and the device coder
(``codec/device_rans.py``, kernels B to E) write and read the same bytes.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

STATE_LB = 1 << 16  # lower bound of the state interval; also the renorm base
PREC = 16           # CDF precision (cdf[L] == 2^16)
DEFAULT_LANES = 192
MAGIC = 0x53_49     # "IS"

_HEADER = struct.Struct("<HHBBHI")  # magic, n_lanes, prec, pad, rsvd, n_syms


def pad_to_lanes(syms: np.ndarray, ctx: np.ndarray, n_lanes: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (syms, ctx) to a multiple of n_lanes by repeating the last entry."""
    pad = (-syms.size) % n_lanes
    if pad:
        syms = np.concatenate([syms, np.full(pad, syms[-1], syms.dtype)])
        ctx = np.concatenate([ctx, np.full(pad, ctx[-1], ctx.dtype)])
    return syms, ctx


def pad_ctx(ctx: np.ndarray, n_lanes: int) -> np.ndarray:
    """Decoder-side context padding: mirrors ``pad_to_lanes``."""
    pad = (-ctx.size) % n_lanes
    if pad:
        ctx = np.concatenate([ctx, np.full(pad, ctx[-1], ctx.dtype)])
    return ctx


def pack_header(n_syms: int, n_lanes: int, prec: int = PREC) -> bytes:
    return _HEADER.pack(MAGIC, n_lanes, prec, 0, 0, n_syms)


def unpack_header(data: bytes) -> Tuple[int, int, int, int]:
    """-> (n_syms, n_lanes, prec, payload_offset)."""
    magic, n_lanes, prec, _, _, n_syms = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise ValueError("bad ilrans magic")
    return n_syms, n_lanes, prec, _HEADER.size


def encode(syms: np.ndarray, ctx: np.ndarray, cdf: np.ndarray,
           n_lanes: int = DEFAULT_LANES, prec: int = PREC) -> bytes:
    """Golden encoder: (n,) symbols in [0, L-1], (n,) CDF-row indices,
    (rows, L+1) int CDF table (cdf[r, 0] = 0, cdf[r, L] = 2^prec,
    non-decreasing) -> header + little-endian u16 word stream."""
    syms = np.ascontiguousarray(syms, np.int64).ravel()
    ctx = np.ascontiguousarray(ctx, np.int64).ravel()
    cdf = np.ascontiguousarray(cdf, np.int64)
    n = syms.size
    header = pack_header(n, n_lanes, prec)
    if n == 0:
        return header
    syms, ctx = pad_to_lanes(syms, ctx, n_lanes)
    t_steps = syms.size // n_lanes
    s2 = syms.reshape(t_steps, n_lanes)
    c2 = ctx.reshape(t_steps, n_lanes)
    lanes = np.arange(n_lanes)

    x = np.full(n_lanes, STATE_LB, np.uint64)
    chunks = []
    for t in range(t_steps - 1, -1, -1):
        row = cdf[c2[t]]                       # (N, L+1)
        s = s2[t]
        start = row[lanes, s].astype(np.uint64)
        freq = (row[lanes, s + 1] - row[lanes, s]).astype(np.uint64)
        # renormalize before encoding: x must be < freq << 16
        need = (x >> np.uint64(16)) >= freq
        if need.any():
            vals = (x & np.uint64(0xFFFF)).astype(np.uint16)
            # the decoder pops lane-ascending within a step: push descending
            chunks.append(vals[need][::-1])
            x = np.where(need, x >> np.uint64(16), x)
        x = (x // freq << np.uint64(prec)) + x % freq + start
    # state flush: the decoder reads (hi, lo) per lane in lane order first
    flush = np.stack([(x & np.uint64(0xFFFF)), (x >> np.uint64(16))],
                     axis=1)[::-1].ravel().astype(np.uint16)
    chunks.append(flush)
    words = np.concatenate(chunks)[::-1]
    return header + words.astype("<u2").tobytes()


def decode(data: bytes, ctx: np.ndarray, cdf: np.ndarray,
           n_syms: int | None = None) -> np.ndarray:
    """Golden decoder: ctx (n,) decoder-known context per symbol (padded
    here) -> (n,) int32 symbols.  Raises ValueError for a stream that does
    not end exactly at its last word with every state at 2^16."""
    n_hdr, n_lanes, prec, off = unpack_header(data)
    n = n_hdr if n_syms is None else n_syms
    if n != n_hdr:
        raise ValueError(f"symbol count mismatch ({n} vs header {n_hdr})")
    if n == 0:
        return np.zeros(0, np.int32)
    ctx = pad_ctx(np.ascontiguousarray(ctx, np.int64).ravel()[:n], n_lanes)
    cdf = np.ascontiguousarray(cdf, np.int64)
    t_steps = ctx.size // n_lanes
    c2 = ctx.reshape(t_steps, n_lanes)
    lanes = np.arange(n_lanes)
    L = cdf.shape[1] - 1

    words = np.frombuffer(data, "<u2", offset=off).astype(np.uint64)
    if words.size < 2 * n_lanes:
        raise ValueError("ilrans stream shorter than its state flush")
    init = words[: 2 * n_lanes].reshape(n_lanes, 2)
    x = (init[:, 0] << np.uint64(16)) | init[:, 1]
    pos = 2 * n_lanes
    mask = np.uint64((1 << prec) - 1)
    out = np.empty((t_steps, n_lanes), np.int32)
    for t in range(t_steps):
        row = cdf[c2[t]]
        slot = (x & mask).astype(np.int64)
        s = (row[:, 1:L] <= slot[:, None]).sum(axis=1)
        start = row[lanes, s]
        freq = row[lanes, s + 1] - start
        x = (freq.astype(np.uint64) * (x >> np.uint64(prec))
             + (slot - start).astype(np.uint64))
        need = x < np.uint64(STATE_LB)
        if need.any():
            nw = words[pos: pos + int(need.sum())]
            if nw.size < int(need.sum()):
                raise ValueError("ilrans stream ends early")
            x = x.copy()
            x[need] = (x[need] << np.uint64(16)) | nw
            pos += nw.size
        out[t] = s
    if pos != words.size or not (x == np.uint64(STATE_LB)).all():
        raise ValueError("corrupt ilrans stream")
    return out.ravel()[:n]
