"""Checkpoint I/O for the port: the JAX package's ``.npz`` files, read with
numpy and carried into torch tensors."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """``reference_weights.npz`` -> {"w0".."w7": int8 [O,kx,ky,I],
    "b0".."b7": int8 [O]} as numpy arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def params_from_jax(np_params: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters (numpy arrays, same layouts) -> CPU
    tensors.  Layouts are kept: weights stay ``[O, kx, ky, I]``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in np_params.items()}


def load_static_cdfs(path: str) -> np.ndarray:
    """``latent_cdfs.npz`` -> (C, L+1) int32 per-channel latent CDFs."""
    with np.load(path) as z:
        return np.ascontiguousarray(z["cdfs"], np.int32)
