"""Interleaved N-lane rANS: the stream format's constants and header.

The port's own copy of what it needs from the JAX package's
``codec/ilrans.py``: N coder states share ONE 16-bit word stream; symbol j
is coded by lane j % N at step j // N; 32-bit states live in
[2^16, 2^32) and renormalize by at most one word per symbol.  A stream is
an 8-byte header followed by the little-endian u16 words: the final state
of every lane as (hi, lo), then the renormalization words in decode order.
"""

from __future__ import annotations

import struct
from typing import Tuple

STATE_LB = 1 << 16  # lower bound of the state interval; also the renorm base
PREC = 16           # CDF precision (cdf[L] == 2^16)
MAGIC = 0x53_49     # "IS"

_HEADER = struct.Struct("<HHBBHI")  # magic, n_lanes, prec, pad, rsvd, n_syms


def pack_header(n_syms: int, n_lanes: int, prec: int = PREC) -> bytes:
    return _HEADER.pack(MAGIC, n_lanes, prec, 0, 0, n_syms)


def unpack_header(data: bytes) -> Tuple[int, int, int, int]:
    """-> (n_syms, n_lanes, prec, payload_offset)."""
    magic, n_lanes, prec, _, _, n_syms = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise ValueError("bad ilrans magic")
    return n_syms, n_lanes, prec, _HEADER.size
