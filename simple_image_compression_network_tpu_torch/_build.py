"""Build and load the port's CUDA kernels.

All of ``csrc/*.cu`` is compiled by ONE ``nvcc`` call into a shared library
with a plain C interface, loaded with ``ctypes``.  No source includes a
PyTorch header, so the build takes seconds, not the minutes a
``torch.utils.cpp_extension`` build of the same sources takes.

The library lands in ``build/torch_kernels/<sha256 of sources and
flags>/libsicn_kernels.so`` under the repository root, at first use.  The
compiler writes to a temporary name that is renamed into place, so a build
that is cut off leaves nothing that a later build would trust or wait on.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_NAME = "libsicn_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (pointers and the stream as c_void_p).
_SIGNATURES = {
    "sicn_conv3x3_s1_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    "sicn_conv_sparse_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sicn_rans_encode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sicn_rans_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sicn_rans_encode_ctx": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    "sicn_rans_encode_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sicn_rans_decode_ctx": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under $CUDA_HOME/bin, else /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: cannot build the CUDA kernels")


def sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile the kernels unless this exact build exists.

    Returns (library path, compiler log).  The log holds ``-Xptxas -v``'s
    register, shared-memory and spill lines of a fresh build ('' when the
    library was already built)."""
    out_dir = os.path.join(_BUILD_ROOT, _digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc exceeded {BUILD_TIMEOUT_S} s") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path, res.stdout + res.stderr


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use, loaded once)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            handle = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
