"""A minimal reader and writer of flax's msgpack checkpoints
(``flax.serialization``).

The JAX package saves the hyperprior weights and its training checkpoints
with ``serialization.to_bytes`` (``utils/train_ckpt.py``): a msgpack map of
maps whose leaves are numpy arrays, each an ext record of type 1 holding
the msgpack triple ``[shape, dtype name, raw C-order bytes]``, and plain
integers (a training checkpoint's step).  The card's machine has no
``msgpack`` package, so the port reads and writes the format itself.

The writer encodes as the ``msgpack`` package does, each value in its
smallest form, so a file read and written again keeps its bytes.  Both
handle what such a checkpoint holds: maps with string keys, strings,
integers, binary, arrays (lists and tuples) and ndarray ext records (type
1, fixext or ext8/16/32).  Anything else raises ``ValueError`` on reading
and ``TypeError`` on writing.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
# integer type byte -> struct format: uint8..64, int8..64
_INT_FORMS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
              0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


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
        if b >= 0xE0:                                  # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:                          # fixmap
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:                          # fixarray
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:                          # fixstr
            return self.str(b & 0x1F)
        if b in _INT_FORMS:
            return self.uint(_INT_FORMS[b])
        if b in (0xD9, 0xDA, 0xDB):                    # str8/16/32
            return self.str(self.uint((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):                          # array16/32
            n = self.uint((">H", ">I")[b - 0xDC])
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):                          # map16/32
            return self.map(self.uint((">H", ">I")[b - 0xDE]))
        if b in (0xC4, 0xC5, 0xC6):                    # bin8/16/32
            n = self.uint((">B", ">H", ">I")[b - 0xC4])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):                    # ext8/16/32
            n = self.uint((">B", ">H", ">I")[b - 0xC7])
            code = self.uint(">b")
            return _ext(code, self.take(n))
        if 0xD4 <= b <= 0xD8:                          # fixext 1..16
            code = self.uint(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
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


def _pack_len(out: list, n: int, fix: int, fix_max: int, forms) -> None:
    """A length header: the fix form below ``fix_max``, else the smallest
    of ``forms`` ((type byte, struct format, largest length), ...)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for code, fmt, top in forms:
        if n <= top:
            out.append(struct.pack(">B" + fmt[1:], code, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    if v > 0:
        forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
                 (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, (1 << 64) - 1))
    else:
        forms = ((0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0),
                 (0xD2, ">i", -(1 << 31), 0), (0xD3, ">q", -(1 << 63), 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(struct.pack(">B" + fmt[1:], code, v))
            return
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack(out: list, obj: Any) -> None:
    if isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 0x0F, _MAP)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: non-string map key {k!r}")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 0x1F, _STR)
        out.append(raw)
    elif isinstance(obj, (bool, np.bool_)) or obj is None:
        raise TypeError(f"msgpack: {obj!r} is not in a checkpoint's format")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, _BIN)
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 0x0F, _ARRAY)
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.isalignedstruct:
            raise TypeError(f"msgpack: dtype {obj.dtype} has no ndarray "
                            f"record")
        payload = dumps([list(obj.shape), obj.dtype.name,
                         obj.tobytes("C")])
        if len(payload) in _FIXEXT:
            out.append(struct.pack(">B", _FIXEXT[len(payload)]))
        else:
            _pack_len(out, len(payload), None, 0, _EXT)
        out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(payload)
    else:
        raise TypeError(f"msgpack: cannot write {type(obj).__name__}")


def dumps(tree: Any) -> bytes:
    """Nested dicts (string keys) of numpy arrays, ints, strings and bytes
    -> msgpack bytes, as ``flax.serialization.msgpack_serialize`` writes
    them.  Dicts keep their order."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)


def dump(path: str, tree: Any) -> None:
    """Write ``dumps(tree)`` to ``path`` (callers that need an atomic
    write go through ``utils/train_ckpt.py``)."""
    with open(path, "wb") as f:
        f.write(dumps(tree))
