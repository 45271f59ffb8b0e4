"""ctypes bindings for the native C++ golden model (``native/golden.cpp``).

The port's own copy of the JAX package's ``utils/native_golden.py``.  The
source (the port's copy) is built at first use with g++ into
``build/torch_host/<sha256 of source and flags>/libgolden.so`` under the
repository root (``_build.compile_library``), never into the package, and
loaded with ctypes.  ``conv2d``/``deconv2d`` raise when g++ is missing or
the build fails: the golden is a host tool, not the card's path.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import _build

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "golden.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
LIB_NAME = "libgolden.so"
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None


def build() -> tuple:
    """Compile the golden unless this exact build exists -> (library path,
    compiler log; '' when it was already built)."""
    return _build.compile_library(_build.find_cxx(), _build.CXX_FLAGS,
                                  [SOURCE], [SOURCE], _BUILD_ROOT, LIB_NAME,
                                  BUILD_TIMEOUT_S)


def load() -> ctypes.CDLL:
    """The golden library, built at first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i8p = ctypes.POINTER(ctypes.c_int8)
            for fn in (lib.golden_conv2d, lib.golden_deconv2d):
                fn.restype = None
                fn.argtypes = [u8p, i8p, i8p, i8p] + [ctypes.c_int64] * 5
            _lib = lib
        return _lib


def _call(fn, x: np.ndarray, w: np.ndarray, bias: np.ndarray,
          out_shape) -> np.ndarray:
    x = np.asarray(x)
    x = np.ascontiguousarray(x.view(np.uint8) if x.dtype == np.int8
                             else x.astype(np.uint8))
    w = np.ascontiguousarray(w, np.int8)
    bias = np.ascontiguousarray(bias, np.int8)
    if (x.ndim != 4 or w.ndim != 4 or w.shape[1:] != (5, 5, x.shape[3])
            or bias.shape != w.shape[:1]):
        raise ValueError(f"expected x (N,X,Y,C), w (O,5,5,C), bias (O,); got "
                         f"{x.shape}, {w.shape}, {bias.shape}")
    n, ix, iy, ci = x.shape
    co = w.shape[0]
    out = np.empty(out_shape, np.int8)
    fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
       w.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
       bias.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
       n, ix, iy, ci, co)
    return out


def conv2d(x: np.ndarray, w: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """The k5/s2/p2 conv layer: x (N, X, Y, C) uint8 (int8 reinterpreted),
    w (O, 5, 5, C) int8, bias (O,) int8 -> (N, X/2, Y/2, O) int8."""
    n, ix, iy, _ = np.shape(x)
    return _call(load().golden_conv2d, x, w, bias,
                 (n, (ix - 1) // 2 + 1, (iy - 1) // 2 + 1, np.shape(w)[0]))


def deconv2d(x: np.ndarray, w: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """The deconv522 layer: (N, X, Y, C) -> (N, 2X, 2Y, O) int8."""
    n, ix, iy, _ = np.shape(x)
    return _call(load().golden_deconv2d, x, w, bias,
                 (n, 2 * ix, 2 * iy, np.shape(w)[0]))
