"""The benchmark's own reading of the codecs' containers: the container
layout, the stream payload, and a plain interleaved-rANS decoder.

Written from the stream format alone (SICT container, "IS" ilrans streams
of N lanes sharing one 16-bit word stream), in plain PyTorch so that it
runs on the card after the window or on the CPU in the tests.  It imports
nothing of the program.

Container: b"SICT" | u8 version | u8 codec id | u16 n | n x u32 length |
sections.  A payload section: u16 S | S x (u32 length | stream).  A
stream: magic u16, lanes u16, precision u8, pad u8, reserved u16, symbols
u32, then u16 words: every lane's final state as (hi, lo), then the
renormalization words in decode order.  Symbol j of a stream is coded by
lane j % N at step j // N.  A step decodes every lane, then the lanes that
fell below 2^16 read one word each, in lane order.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

MAGIC = b"SICT"
VERSION = 2
STATE_LB = 1 << 16
_STREAM = struct.Struct("<HHBBHI")
_STREAM_MAGIC = 0x5349


def unpack_container(data: bytes) -> Tuple[int, List[bytes]]:
    """-> (codec id, sections); ValueError for anything malformed."""
    if data[:4] != MAGIC:
        raise ValueError("bad container magic")
    version, codec_id, n = struct.unpack_from("<BBH", data, 4)
    if version != VERSION:
        raise ValueError(f"container version {version}")
    lens = struct.unpack_from(f"<{n}I", data, 8)
    off, out = 8 + 4 * n, []
    for ln in lens:
        out.append(data[off:off + ln])
        off += ln
    if off != len(data):
        raise ValueError("container length mismatch")
    return codec_id, out


def unpack_streams(payload: bytes) -> List[bytes]:
    (s,) = struct.unpack_from("<H", payload)
    out, off = [], 2
    for _ in range(s):
        (ln,) = struct.unpack_from("<I", payload, off)
        out.append(payload[off + 4: off + 4 + ln])
        off += 4 + ln
    if off != len(payload):
        raise ValueError("payload length mismatch")
    return out


def unpack_raw(section: bytes) -> np.ndarray:
    """An escape side section: u32 count, then count int32 values."""
    (count,) = struct.unpack_from("<I", section)
    if len(section) != 4 + 4 * count:
        raise ValueError("escape section length mismatch")
    return np.frombuffer(section, "<i4", count=count, offset=4).astype(
        np.int64)


def stream_shape(stream: bytes) -> Tuple[int, int]:
    """-> (symbols, lanes) of one stream."""
    magic, lanes, prec, _, _, n_syms = _STREAM.unpack_from(stream)
    if magic != _STREAM_MAGIC or prec != 16:
        raise ValueError("bad stream header")
    return n_syms, lanes


def inverse_table(cdf: torch.Tensor) -> torch.Tensor:
    """(R, L+1) CDF rows summing to 2^16 -> (R, 2^16) the symbol of each
    slot: the s with cdf[s] <= slot < cdf[s+1]."""
    slots = torch.arange(STATE_LB, device=cdf.device, dtype=cdf.dtype)
    return torch.searchsorted(cdf[:, 1:].contiguous(),
                              slots.expand(cdf.shape[0], -1).contiguous(),
                              right=True)


def decode(streams: Sequence[bytes], rows: torch.Tensor, cdf: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode S streams of one shape.

    rows: the CDF row of each symbol, broadcastable to (S, t, N); cdf:
    (R, L+1) int64 on the decoding device.  -> (symbols (S, t*N) int64,
    ok (S,) bool): ok where the stream ended on its last word with every
    state at 2^16."""
    dev = cdf.device
    n_syms, n_lanes = stream_shape(streams[0])
    if any(stream_shape(s) != (n_syms, n_lanes) for s in streams):
        raise ValueError("streams of different shapes")
    t_steps = -(-n_syms // n_lanes)
    words = [np.frombuffer(s, "<u2", offset=_STREAM.size) for s in streams]
    lengths = torch.tensor([w.size for w in words], device=dev)
    cap = max(w.size for w in words) + 1
    buf = np.zeros((len(words), cap), np.int64)
    for i, w in enumerate(words):
        buf[i, :w.size] = w
    buf = torch.from_numpy(buf).to(dev)
    if int(lengths.min()) < 2 * n_lanes:
        return (torch.zeros((len(words), t_steps * n_lanes), dtype=torch.int64,
                            device=dev),
                torch.zeros(len(words), dtype=torch.bool, device=dev))
    rows = rows.expand(len(words), t_steps, n_lanes)
    inv = inverse_table(cdf)
    x = (buf[:, 0:2 * n_lanes:2] << 16) | buf[:, 1:2 * n_lanes:2]
    pos = torch.full((len(words),), 2 * n_lanes, dtype=torch.int64,
                     device=dev)
    out = torch.empty((len(words), t_steps, n_lanes), dtype=torch.int64,
                      device=dev)
    for t in range(t_steps):
        r = rows[:, t]
        slot = x & 0xFFFF
        sym = inv[r, slot]
        start = cdf[r, sym]
        freq = cdf[r, sym + 1] - start
        x = freq * (x >> 16) + slot - start
        need = x < STATE_LB
        k = need.to(torch.int64)
        idx = (pos[:, None] + torch.cumsum(k, 1) - k).clamp(max=cap - 1)
        x = torch.where(need, (x << 16) | torch.gather(buf, 1, idx), x)
        pos = pos + k.sum(1)
        out[:, t] = sym
    ok = (pos == lengths) & (x == STATE_LB).all(1)
    return out.reshape(len(words), -1)[:, :n_syms], ok


def quantize_cdf(pmf: np.ndarray) -> np.ndarray:
    """A pmf (symbols then the overflow bucket) -> an int64 CDF of 16-bit
    precision, every symbol at least 1; rounding repaired from the largest
    bins, or given to the most under-served one (the codecs' rule)."""
    total = 1 << 16
    pmf = np.clip(np.asarray(pmf, np.float64), 0, 1)
    freq = np.maximum(np.round(pmf * total).astype(np.int64), 1)
    excess = int(freq.sum()) - total
    while excess != 0:
        if excess > 0:
            i = int(np.argmax(freq))
            take = min(excess, int(freq[i]) - 1)
            if take == 0:
                raise ValueError("cannot normalize CDF")
            freq[i] -= take
            excess -= take
        else:
            i = int(np.argmax(pmf - freq / total))
            freq[i] += -excess
            excess = 0
    return np.concatenate([[0], np.cumsum(freq)]).astype(np.int64)
