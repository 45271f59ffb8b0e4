"""Checkpoint I/O for the port: the JAX package's ``.npz`` files, read with
numpy, and its flax ``.msgpack`` hyperprior checkpoints, read with the
port's own ``utils/msgpack_io.py``; both carried into torch tensors, and
the hyperprior parameters carried back into flax's tree
(``hyper_params_to_jax``) for the training checkpoints."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import msgpack_io


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


def load_hyper_checkpoint(path: str) -> dict:
    """``hp_*.params.msgpack`` (``train_ckpt.save_params``) -> the flax
    variables ``{"params": {"g_a": {...}, ...}}`` as nested numpy dicts."""
    tree = msgpack_io.load(path)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: not a params checkpoint")
    return tree["params"]


def _leaf_to_torch(path: str, name: str, v: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(v))   # a writable copy
    if name != "kernel":
        return t            # biases, GDN and bottleneck raw values as-is
    if "ConvTranspose" in path:
        # (kh, kw, in, out) -> conv_transpose2d's (in, out, kh, kw); flax
        # does not flip the kernel of a transposed conv, PyTorch does
        return t.permute(2, 3, 0, 1).flip(2, 3).contiguous()
    return t.permute(3, 2, 0, 1).contiguous()   # -> (out, in, kh, kw)


def hyper_params_from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """Flax variables of a (scale-)hyperprior -> a ``state_dict`` of the
    port's ``models/hyperprior.py`` modules (CPU float32 tensors).

    Module names are kept (``g_a.Conv_0``, ``h_s.ConvTranspose_1``,
    ``bottleneck.H0``); ``kernel`` becomes ``weight`` in PyTorch's layout.
    GDN ``beta``/``gamma`` and the bottleneck's ``H*``/``b*``/``a*`` keep
    their raw (pre-reparameterization) values."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: dict, prefix: str) -> None:
        for name, v in tree.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(v, dict):
                walk(v, path)
            else:
                key = (f"{prefix}.weight" if name == "kernel" else path)
                out[key] = _leaf_to_torch(prefix, name, v)

    walk(variables["params"], "")
    return out


def _leaf_to_jax(module: str, name: str, t: torch.Tensor) -> np.ndarray:
    """The inverse of ``_leaf_to_torch``: a port tensor -> the flax leaf."""
    t = t.detach().cpu()
    if name == "weight":
        if "ConvTranspose" in module:       # undo permute(2, 3, 0, 1).flip
            t = t.flip(2, 3).permute(2, 3, 0, 1)
        else:                               # (out, in, kh, kw) -> HWIO
            t = t.permute(2, 3, 1, 0)
    return np.ascontiguousarray(t.numpy())


def hyper_params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """A ``state_dict`` of the port's hyperprior modules (or a tree of the
    same names and shapes: Adam's moments) -> flax variables
    ``{"params": {...}}`` of numpy arrays, the inverse of
    ``hyper_params_from_jax``.  Keys are sorted at every level, as JAX's
    tree functions leave a flax tree."""
    tree: dict = {}
    for key, t in state.items():
        *path, name = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node["kernel" if name == "weight" else name] = _leaf_to_jax(
            ".".join(path), name, t)

    def ordered(node):
        return ({k: ordered(node[k]) for k in sorted(node)}
                if isinstance(node, dict) else node)

    return {"params": ordered(tree)}
