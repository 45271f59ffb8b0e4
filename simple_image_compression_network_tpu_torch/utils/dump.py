"""Tensor-dump hooks: the ``logStringStream`` analog (utils.hpp:89-106).

The PyTorch counterpart of the JAX package's ``utils/dump.py``.  The
reference can dump any FIFO to a hex file and restore it; here any
intermediate activation can be dumped to ``<dir>/<name>_<n>.npy`` for
cross-checking against the golden model, and a dump loaded back as a layer
input.  A dump copies the tensor to the host, which waits for the device:
inside a CUDA graph capture that wait is not allowed, so ``dump`` raises
there (the JAX package's ``io_callback`` is safe under ``jit``; the port's
counterpart of ``jit`` is the capture, and there it refuses).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

_active_dir: Optional[str] = None
_counter: Dict[str, int] = {}


def enable(directory: str) -> None:
    global _active_dir
    os.makedirs(directory, exist_ok=True)
    _active_dir = directory
    _counter.clear()


def disable() -> None:
    global _active_dir
    _active_dir = None


def dump(name: str, value: torch.Tensor) -> torch.Tensor:
    """Save ``value`` to <dir>/<name>_<n>.npy when enabled; identity
    otherwise.  Raises inside a CUDA graph capture."""
    if _active_dir is None:
        return value
    if value.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"dump({name!r}) inside a CUDA graph capture: the "
                           f"copy to the host would wait for the device")
    n = _counter.get(name, 0)
    _counter[name] = n + 1
    np.save(os.path.join(_active_dir, f"{name}_{n}.npy"),
            value.detach().cpu().numpy())
    return value


def load(directory: str, name: str, n: int = 0) -> np.ndarray:
    return np.load(os.path.join(directory, f"{name}_{n}.npy"))
