"""A minimal reader of flax's msgpack checkpoints (``flax.serialization``).

The JAX package saves the hyperprior weights with ``serialization.to_bytes``
(``utils/train_ckpt.py``): a msgpack map of maps whose leaves are numpy
arrays, each an ext record of type 1 holding the msgpack triple
``[shape, dtype name, raw C-order bytes]``.  The card's machine has no
``msgpack`` package, so the port reads the format itself.

Only what such a checkpoint uses is read: fixmap/map16, fixstr/str8,
fixarray, positive fixint/uint8/uint16, bin8/16/32 and ext8/16/32 with
type 1.  Anything else raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def uint(self, fmt: str) -> int:
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def obj(self) -> Any:
        b = self.uint(">B")
        if b <= 0x7F:                                  # positive fixint
            return b
        if 0x80 <= b <= 0x8F:                          # fixmap
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:                          # fixarray
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:                          # fixstr
            return self.str(b & 0x1F)
        if b == 0xCC:
            return self.uint(">B")
        if b == 0xCD:
            return self.uint(">H")
        if b == 0xD9:
            return self.str(self.uint(">B"))
        if b == 0xDE:
            return self.map(self.uint(">H"))
        if b in (0xC4, 0xC5, 0xC6):                    # bin8/16/32
            n = self.uint((">B", ">H", ">I")[b - 0xC4])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):                    # ext8/16/32
            n = self.uint((">B", ">H", ">I")[b - 0xC7])
            code = self.uint(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} at "
                         f"offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, str):
                raise ValueError(f"msgpack: non-string map key {key!r}")
            out[key] = self.obj()
        return out


def _ext(code: int, payload: memoryview) -> np.ndarray:
    if code != _EXT_NDARRAY:
        raise ValueError(f"msgpack: unsupported ext type {code}")
    inner = _Reader(bytes(payload))
    triple = inner.obj()
    if (not isinstance(triple, list) or len(triple) != 3
            or inner.pos != len(inner.data)):
        raise ValueError("msgpack: malformed ndarray record")
    shape, dtype, raw = triple
    arr = np.frombuffer(raw, dtype=np.dtype(dtype))
    return arr.reshape(tuple(shape)).copy()


def loads(data: bytes) -> Any:
    """msgpack bytes -> nested dicts of numpy arrays (and plain values)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes")
    return out


def load(path: str) -> Any:
    """Read a checkpoint file (see ``loads``)."""
    with open(path, "rb") as f:
        return loads(f.read())
