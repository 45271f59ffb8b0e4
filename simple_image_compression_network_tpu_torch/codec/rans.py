"""The host rANS coders: ctypes bindings to the native C++ coder and its
Python golden.

The port's own copy of the JAX package's ``codec/rans.py``.  The native
coder (``native/rans.cpp``, the port's copy) is built at first use with
g++ into ``build/torch_host/<sha256 of source and flags>/librans.so`` under
the repository root (``_build.compile_library``) and loaded with ctypes; a
failed build raises.  The Python goldens are reached only by asking for
them (``use_native=False``): they are about 1000x slower.

Two formats:

* the serial coder (``encode``/``decode``): one byte-renormalized stream;
  symbols are table indices into per-context CDF rows (int32 [rows, L+1],
  ``entropy.quantize_cdf``); the last index of each row is an escape bucket
  followed by a 32-bit zig-zag bypass of the raw value;
* the interleaved N-lane coder (``encode_interleaved``/
  ``decode_interleaved``), the ``codec/ilrans.py`` format that the device
  coder also writes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import numpy as np

from .. import _build
from . import ilrans

_RANS_L = 1 << 23
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "rans.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
LIB_NAME = "librans.so"
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None


def build() -> tuple:
    """Compile the host coder unless this exact build exists -> (library
    path, compiler log; '' when it was already built)."""
    return _build.compile_library(_build.find_cxx(), _build.CXX_FLAGS,
                                  [SOURCE], [SOURCE], _BUILD_ROOT, LIB_NAME,
                                  BUILD_TIMEOUT_S)


def load_native() -> ctypes.CDLL:
    """The host coder, built at first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            for name, argtypes in (
                    ("ilrans_encode",
                     [i32p, i32p, i64, i32p, i32, i32, i32, u16p]),
                    ("ilrans_decode",
                     [u16p, i64, i64, i32p, i32p, i32, i32, i32, i32p]),
                    ("rans_encode",
                     [i32p, i32p, i64, i32p, i32, i32, i32p, u8p, i64]),
                    ("rans_decode",
                     [u8p, i64, i64, i32p, i32p, i32, i32, i32p, i32p])):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = i64
            _lib = lib
        return _lib


def _asi32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _ptr(a: np.ndarray, ctype):
    """A C pointer into ``a``, which must be C-contiguous: a strided view
    would be read as if it were packed."""
    if not a.flags.c_contiguous:
        raise ValueError("the native coder takes contiguous arrays")
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_table(cdf: np.ndarray, ctx: np.ndarray,
                 syms: np.ndarray | None = None) -> None:
    """Indices the native coder would follow must lie inside the table."""
    if cdf.ndim != 2 or cdf.shape[1] < 2:
        raise ValueError(f"cdf must be (rows, L+1), got {cdf.shape}")
    if ctx.size and (ctx.min() < 0 or ctx.max() >= cdf.shape[0]):
        raise ValueError("context index outside the table")
    if syms is not None and syms.size and (
            syms.min() < 0 or syms.max() >= cdf.shape[1] - 1):
        raise ValueError("symbol outside the table's alphabet")


def encode(syms: np.ndarray, ctx: np.ndarray, cdf: np.ndarray,
           prec: int = ilrans.PREC, raw: np.ndarray | None = None, *,
           use_native: bool = True) -> bytes:
    """Serial coder: symbols (table indices) against per-context CDF rows;
    ``raw`` holds the values that escape symbols bypass-code."""
    syms, ctx = _asi32(syms).ravel(), _asi32(ctx).ravel()
    cdf = _asi32(cdf)
    n = syms.size
    L = cdf.shape[1] - 1
    raw = _asi32(raw).ravel() if raw is not None else np.zeros(n, np.int32)
    if ctx.size != n or raw.size != n:
        raise ValueError("syms, ctx and raw must have one entry a symbol")
    _check_table(cdf, ctx, syms)
    if not use_native:
        return _encode_py(syms, ctx, cdf, prec, raw)
    lib = load_native()
    cap = 16 + 8 * n + 4
    out = np.empty(cap, np.uint8)
    ln = lib.rans_encode(_ptr(syms, ctypes.c_int32), _ptr(ctx, ctypes.c_int32),
                         n, _ptr(cdf, ctypes.c_int32), L, prec,
                         _ptr(raw, ctypes.c_int32), _ptr(out, ctypes.c_uint8),
                         cap)
    if ln < 0:
        raise RuntimeError(f"rans_encode failed ({ln})")
    return out[:ln].tobytes()


def decode(data: bytes, n: int, ctx: np.ndarray, cdf: np.ndarray,
           prec: int = ilrans.PREC, *, use_native: bool = True
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode n serial-coded symbols -> (table indices, bypass raw values,
    0 unless the symbol was an escape)."""
    ctx = _asi32(ctx).ravel()
    cdf = _asi32(cdf)
    if ctx.size < n:
        raise ValueError("fewer contexts than symbols")
    _check_table(cdf, ctx[:n])
    if not use_native:
        return _decode_py(data, n, ctx, cdf, prec)
    lib = load_native()
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int32)
    raw = np.empty(n, np.int32)
    consumed = lib.rans_decode(_ptr(buf, ctypes.c_uint8), buf.size, n,
                               _ptr(ctx, ctypes.c_int32),
                               _ptr(cdf, ctypes.c_int32), cdf.shape[1] - 1,
                               prec, _ptr(out, ctypes.c_int32),
                               _ptr(raw, ctypes.c_int32))
    if consumed < 0:
        raise ValueError("rans_decode failed: stream too short")
    return out, raw


# ---------------------------------------------------------------------------
# Pure-Python golden of the serial coder (bit-identical bytestream)
# ---------------------------------------------------------------------------

def _enc_put(x: int, sink: list, start: int, freq: int, prec: int) -> int:
    x_max = ((_RANS_L >> prec) << 8) * freq
    while x >= x_max:
        sink.append(x & 0xFF)
        x >>= 8
    return (x // freq << prec) + x % freq + start


def _encode_py(syms, ctx, cdf, prec, raw) -> bytes:
    x = _RANS_L
    sink: list = []
    escape = cdf.shape[1] - 2
    for i in range(len(syms) - 1, -1, -1):
        s = int(syms[i])
        row = cdf[int(ctx[i])]
        if s == escape:
            zz = ((int(raw[i]) << 1) ^ (int(raw[i]) >> 31)) & 0xFFFFFFFF
            for shift in (24, 16, 8, 0):
                byte = (zz >> shift) & 0xFF
                x = _enc_put(x, sink, byte << 8, 1 << 8, 16)
        start, end = int(row[s]), int(row[s + 1])
        x = _enc_put(x, sink, start, end - start, prec)
    for _ in range(4):
        sink.append(x & 0xFF)
        x >>= 8
    return bytes(reversed(sink))


def _decode_py(data: bytes, n: int, ctx, cdf, prec):
    if len(data) < 4:
        raise ValueError("rans stream too short")
    pos = 0
    x = 0
    for _ in range(4):
        x = (x << 8) | data[pos]
        pos += 1
    mask = (1 << prec) - 1
    escape = cdf.shape[1] - 2

    def refill(x, pos):
        while x < _RANS_L:
            if pos >= len(data):
                raise ValueError("rans stream too short")
            x = (x << 8) | data[pos]
            pos += 1
        return x, pos

    out = np.empty(n, np.int32)
    raw = np.zeros(n, np.int32)
    for i in range(n):
        row = cdf[int(ctx[i])]
        slot = x & mask
        s = int(np.searchsorted(row, slot, side="right")) - 1
        start, freq = int(row[s]), int(row[s + 1]) - int(row[s])
        x, pos = refill(freq * (x >> prec) + slot - start, pos)
        out[i] = s
        if s == escape:
            zz = 0
            for k in range(4):
                bslot = x & 0xFFFF
                byte = bslot >> 8
                x, pos = refill((x >> 16 << 8) + bslot - (byte << 8), pos)
                zz |= byte << (8 * k)
            raw[i] = np.int32(np.uint32((zz >> 1) ^ (-(zz & 1) & 0xFFFFFFFF)))
    return out, raw


# ---------------------------------------------------------------------------
# Interleaved N-lane rANS (the codec/ilrans.py format)
# ---------------------------------------------------------------------------

def encode_interleaved(syms: np.ndarray, ctx: np.ndarray, cdf: np.ndarray,
                       n_lanes: int = ilrans.DEFAULT_LANES,
                       prec: int = ilrans.PREC, *,
                       use_native: bool = True) -> bytes:
    """Interleaved coder: (n,) symbols, (n,) CDF-row indices -> header +
    u16 words, on the native coder or (``use_native=False``) the golden."""
    syms = _asi32(syms).ravel()
    ctx = _asi32(ctx).ravel()
    cdf = _asi32(cdf)
    if ctx.size != syms.size:
        raise ValueError("syms and ctx must have one entry a symbol")
    _check_table(cdf, ctx, syms)
    if not use_native:
        return ilrans.encode(syms, ctx, cdf, n_lanes, prec)
    lib = load_native()
    n = syms.size
    header = ilrans.pack_header(n, n_lanes, prec)
    if n == 0:
        return header
    syms, ctx = ilrans.pad_to_lanes(syms, ctx, n_lanes)
    words = np.empty(2 * n_lanes + syms.size, np.uint16)
    n_words = lib.ilrans_encode(_ptr(syms, ctypes.c_int32),
                                _ptr(ctx, ctypes.c_int32), syms.size,
                                _ptr(cdf, ctypes.c_int32), cdf.shape[1] - 1,
                                prec, n_lanes, _ptr(words, ctypes.c_uint16))
    if n_words < 0:
        raise RuntimeError(f"ilrans_encode failed ({n_words})")
    return header + words[:n_words].astype("<u2").tobytes()


def decode_interleaved(data: bytes, ctx: np.ndarray, cdf: np.ndarray, *,
                       use_native: bool = True) -> np.ndarray:
    """Decode an interleaved stream -> int32 symbols (as many as its header
    says; ``ctx`` holds at least that many).  Raises ValueError for a
    corrupt stream."""
    cdf = _asi32(cdf)
    n, n_lanes, prec, off = ilrans.unpack_header(data)
    ctx = _asi32(ctx).ravel()
    if ctx.size < n:
        raise ValueError("fewer contexts than symbols")
    _check_table(cdf, ctx[:n])
    if not use_native:
        return ilrans.decode(data, ctx, cdf)
    lib = load_native()
    if n == 0:
        return np.zeros(0, np.int32)
    ctx = ilrans.pad_ctx(ctx[:n], n_lanes)
    words = np.frombuffer(data, "<u2", offset=off)
    out = np.empty(ctx.size, np.int32)
    consumed = lib.ilrans_decode(_ptr(words, ctypes.c_uint16), words.size,
                                 ctx.size, _ptr(ctx, ctypes.c_int32),
                                 _ptr(cdf, ctypes.c_int32), cdf.shape[1] - 1,
                                 prec, n_lanes, _ptr(out, ctypes.c_int32))
    if consumed != words.size:
        raise ValueError(f"corrupt ilrans stream (consumed {consumed} of "
                         f"{words.size} words)")
    return out[:n]
