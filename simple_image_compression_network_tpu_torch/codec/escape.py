"""Escape side channel for the bounded-alphabet device rANS format.

The port's own copy of the JAX package's ``codec/escape.py``.  Values
outside [-max_abs, max_abs] are coded in-stream as one ESCAPE symbol (the
tables' overflow bucket) and carried raw in a side section, in scan order:
``<u32 count> count * <i32 raw value>``.  ``to_symbols`` runs on the
tensor's device; the side-section helpers are host numpy.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
import torch


def escape_symbol(max_abs: int) -> int:
    """Index of the escape symbol for a [-max_abs, max_abs] alphabet."""
    return 2 * max_abs + 1


def alphabet_size(max_abs: int) -> int:
    """Symbols 0..2*max_abs (centered values) plus the escape bucket."""
    return 2 * max_abs + 2


def to_symbols(vals: torch.Tensor, max_abs: int) -> torch.Tensor:
    """Centered integer values -> int32 symbol indices with escapes."""
    v = vals.to(torch.int32)
    sym = torch.clamp(v, -max_abs, max_abs) + max_abs
    return torch.where(v.abs() > max_abs,
                       torch.full_like(sym, escape_symbol(max_abs)), sym)


def pack_raw(vals: np.ndarray, max_abs: int) -> bytes:
    """Out-of-range values (scan order) -> side-section bytes."""
    v = np.asarray(vals, np.int64).ravel()
    raw = v[np.abs(v) > max_abs].astype("<i4")
    return struct.pack("<I", raw.size) + raw.tobytes()


def unpack_raw(data: bytes) -> Tuple[np.ndarray, int]:
    """Side-section bytes -> (raw values, bytes consumed)."""
    (count,) = struct.unpack_from("<I", data)
    raw = np.frombuffer(data, "<i4", count=count, offset=4).astype(np.int64)
    return raw, 4 + 4 * count


def from_symbols(syms: np.ndarray, raw: np.ndarray,
                 max_abs: int) -> np.ndarray:
    """Decoded symbols + raw side values -> centered integer values.
    ``raw`` must hold exactly the escape count, in scan order."""
    s = np.asarray(syms, np.int64).ravel()
    out = s - max_abs
    esc = s == escape_symbol(max_abs)
    n_esc = int(esc.sum())
    if n_esc != raw.size:
        raise ValueError(
            f"escape count mismatch: {n_esc} escapes, {raw.size} raw values")
    if n_esc:
        out[esc] = raw
    return out
