"""Minimal bitstream container: magic, version, typed sections (the port's
own copy of the JAX package's ``codec/container.py``, byte-compatible).

Layout: b"SICT" | u8 version | u8 codec_id | u16 n_sections |
        n * (u32 length) | section bytes...
"""

from __future__ import annotations

import struct
from typing import List, Tuple

MAGIC = b"SICT"
VERSION = 2  # v2: entropy payloads use interleaved N-lane rANS (ilrans)

CODEC_INT8 = 1        # bit-exact integer autoencoder + lossless latent coding
CODEC_HYPERPRIOR = 2  # float transforms + scale hyperprior (host serial rans)
CODEC_HYPERPRIOR_DEV = 3  # hyperprior with on-device interleaved-rANS coding


def pack(codec_id: int, sections: List[bytes]) -> bytes:
    head = MAGIC + struct.pack("<BBH", VERSION, codec_id, len(sections))
    lens = b"".join(struct.pack("<I", len(s)) for s in sections)
    return head + lens + b"".join(sections)


def unpack(data: bytes) -> Tuple[int, List[bytes]]:
    if data[:4] != MAGIC:
        raise ValueError("bad magic")
    version, codec_id, n = struct.unpack("<BBH", data[4:8])
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    off = 8
    lens = []
    for _ in range(n):
        (ln,) = struct.unpack("<I", data[off:off + 4])
        lens.append(ln)
        off += 4
    sections = []
    for ln in lens:
        sections.append(data[off:off + ln])
        off += ln
    if off != len(data):
        raise ValueError("trailing bytes")
    return codec_id, sections
