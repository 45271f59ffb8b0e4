"""Static validation: the HLS pragma-discipline analog.

The PyTorch counterpart of the JAX package's ``utils/checks.py``.  The
reference guards shape and divisibility preconditions with CASSERT_DATAFLOW
(bnn-library.h:55) and asserts race-freedom with DEPENDENCE pragmas; here
the equivalents are plain checks that raise, and a determinism check (run
again and compare bit for bit: a mismatch shows a race or a
nondeterministic algorithm).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_WIRE = (torch.int8, torch.uint8, np.dtype(np.int8), np.dtype(np.uint8))


def assert_divisible(value: int, by: int, what: str = "dim") -> None:
    if value % by:
        raise ValueError(f"{what}={value} must be divisible by {by} "
                         f"(CASSERT_DATAFLOW analog)")


def assert_feature_map(x, channels: Optional[int] = None) -> None:
    """Feature maps are rank-4 (N, X, Y, C)."""
    if len(x.shape) != 4:
        raise AssertionError(f"feature map of rank {len(x.shape)}, "
                             f"expected 4 (N, X, Y, C)")
    if channels is not None and x.shape[3] != channels:
        raise AssertionError(f"feature map has {x.shape[3]} channels, "
                             f"expected {channels}")


def assert_int8_wire(x) -> None:
    """Wire activations are int8 or uint8 (a tensor or a numpy array)."""
    if x.dtype not in _WIRE:
        raise AssertionError(f"wire activations are int8 or uint8, "
                             f"got {x.dtype}")


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    return [out]


def _same_bits(a, b) -> bool:
    if not isinstance(a, torch.Tensor):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if not isinstance(b, torch.Tensor) or a.dtype != b.dtype or \
            a.shape != b.shape:
        return False
    return torch.equal(a.detach().cpu().reshape(-1).view(torch.uint8),
                       b.detach().cpu().reshape(-1).view(torch.uint8))


def assert_deterministic(fn: Callable, *args, runs: int = 2) -> None:
    """Run ``fn(*args)`` ``runs`` times and require bit-identical outputs
    (tensors compared byte for byte, so a NaN equals itself)."""
    ref = _leaves(fn(*args))
    for i in range(1, runs):
        out = _leaves(fn(*args))
        if len(out) != len(ref) or not all(
                _same_bits(a, b) for a, b in zip(ref, out)):
            raise AssertionError(f"run {i} differs from run 0")
