"""Build and load the port's CUDA kernels.

All of ``csrc/*.cu`` is compiled by ONE ``nvcc`` call into a shared library
with a plain C interface, loaded with ``ctypes``.  No source includes a
PyTorch header, so the build takes seconds, not the minutes a
``torch.utils.cpp_extension`` build of the same sources takes.

The library lands in ``build/torch_kernels/<sha256 of sources and
flags>/libsicn_kernels.so`` under the repository root, at first use.  The
compiler writes to a temporary name that is renamed into place, so a build
that is cut off leaves nothing that a later build would trust or wait on.
The host libraries, the rANS coder (``codec/rans.py``) and the native golden
(``utils/native_golden.py``), are built by the same ``compile_library`` with
g++.
"""

from __future__ import annotations

import ctypes
import functools
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
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")   # host libraries

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
    "sicn_rans_encode_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _P],
    "sicn_deconv5s2_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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


def find_cxx() -> str:
    """``g++`` on PATH, for the host libraries (the rANS coder, the native
    golden)."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: cannot build the host "
                           "libraries")
    return found


def sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest(flags, paths) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(paths):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def compile_library(compiler: str, flags, srcs, hashed, root: str,
                    name: str, timeout: int) -> tuple:
    """``compiler flags -o root/<digest>/name srcs`` unless that library
    exists; ``digest`` covers the flags and the files ``hashed`` (the
    sources and what they include).  The compiler writes a temporary name
    that is renamed into place.  Returns (library path, compiler log); the
    log is '' when the library was already built."""
    out_dir = os.path.join(root, _digest(flags, hashed))
    lib_path = os.path.join(out_dir, name)
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    tool = os.path.basename(compiler)
    try:
        res = subprocess.run([compiler, *flags, "-o", tmp, *srcs],
                             capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{tool} exceeded {timeout} s") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{tool} failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path, res.stdout + res.stderr


def build() -> tuple:
    """Compile the kernels unless this exact build exists.

    Returns (library path, compiler log).  The log holds ``-Xptxas -v``'s
    register, shared-memory and spill lines of a fresh build ('' when the
    library was already built)."""
    return compile_library(find_nvcc(), NVCC_FLAGS, sources(),
                           glob.glob(os.path.join(_CSRC, "*.cu*")),
                           _BUILD_ROOT, LIB_NAME, BUILD_TIMEOUT_S)


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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
