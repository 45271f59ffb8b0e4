"""Checkpoint I/O for the port: the reference's parameter header, the JAX
package's ``.npz`` files, read with numpy, and its flax ``.msgpack``
checkpoints, read with the port's own ``utils/msgpack_io.py``; carried
into torch tensors, and the hyperprior and integer-training parameters
carried back into flax's trees (``hyper_params_to_jax``,
``intnet_params_to_jax``) for the training checkpoints.

The reference ships its trained parameters as compile-time hex constants in
``memdata_nonsquare.h``: per layer a ``FixedPointWeights<SIMD, ap_int<WBIT>,
PE, TILES>`` whose storage is ``ap_uint<SIMD*WBIT> m_weights[PE][TILES]``
(``weights.hpp:110-150``), the SIMD fields little-endian inside each word,
and a bias ``FixedPointWeights<1, ap_int<8>, 1, OFM_CH>``.  For each ``pe``
the flat (tile*SIMD + simd) index enumerates, fastest to slowest, input
channel, kx, ky, out-channel block, and the dense out channel is
``pe + PE * block`` (``conv3_nonsquare_tb.cpp:538-571``).  The loaders
below are the port's own copy of the JAX package's, numpy only."""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig, REFERENCE_NET
from . import msgpack_io

_DECL_RE = re.compile(
    r"FixedPointWeights<\s*(\d+)\s*,\s*ap_int<(\d+)>\s*,\s*(\d+)\s*,"
    r"\s*(\d+)\s*>\s*(\w+)\s*=")
_HEX_RE = re.compile(r"0x[0-9a-fA-F]+")


def _sign_extend(vals: np.ndarray, bits: int) -> np.ndarray:
    """Two's-complement sign extension of ``bits``-wide fields held in
    int64."""
    sign = np.int64(1) << (bits - 1)
    return ((vals ^ sign) - sign).astype(np.int64)


def _unpack_words(words: np.ndarray, simd: int, wbit: int) -> np.ndarray:
    """Packed ap_uint<SIMD*WBIT> words -> SIMD sign-extended fields, field
    i in bits [i*WBIT, (i+1)*WBIT) (``weights.hpp:131-141``).  Returns
    shape words.shape + (simd,)."""
    shifts = np.arange(simd, dtype=np.int64) * wbit
    fields = (words[..., None] >> shifts) & ((np.int64(1) << wbit) - 1)
    return _sign_extend(fields, wbit)


def parse_memdata_header(path: str) -> Dict[str, np.ndarray]:
    """``memdata_nonsquare.h`` -> {name: int64 (PE, TILES, SIMD)} of
    sign-extended fields, for every ``FixedPointWeights`` declaration."""
    with open(path, "r") as f:
        text = f.read()
    out: Dict[str, np.ndarray] = {}
    for m in _DECL_RE.finditer(text):
        simd, wbit, pe, tiles = (int(m.group(i)) for i in range(1, 5))
        name = m.group(5)
        # everything up to the initializer's matching "}"
        start = text.index("{", m.end())
        depth, i = 0, start
        while True:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        words = np.array([int(h, 16) for h in
                          _HEX_RE.findall(text[start:i + 1])],
                         dtype=np.uint64).astype(np.int64)
        if words.size != pe * tiles:
            raise ValueError(f"{name}: parsed {words.size} words, "
                             f"expected PE*TILES={pe * tiles}")
        out[name] = _unpack_words(words.reshape(pe, tiles), simd, wbit)
    return out


def fold_to_dense(folded: np.ndarray, out_ch: int, in_ch: int, k: int
                  ) -> np.ndarray:
    """(PE, TILES, SIMD) fold layout -> dense [O, kx, ky, I] int8: per pe
    the flat stream is [out-block][ky][kx][in-channel], slowest first."""
    pe_n, tiles, simd = folded.shape
    flat = folded.reshape(pe_n, tiles * simd)
    assert tiles * simd == (out_ch // pe_n) * k * k * in_ch
    per_pe = flat.reshape(pe_n, out_ch // pe_n, k, k, in_ch)
    dense = np.zeros((out_ch, k, k, in_ch), np.int8)
    for pe in range(pe_n):
        # [blk, ky, kx, I] -> [blk, kx, ky, I]
        dense[pe::pe_n] = per_pe[pe].transpose(0, 2, 1, 3).astype(np.int8)
    return dense


def load_reference_params(header_path: str,
                          cfg: ModelConfig = REFERENCE_NET
                          ) -> Dict[str, np.ndarray]:
    """All 8 layers' weights and biases from the reference header:
    {"w0".."w7": int8 [O,kx,ky,I], "b0".."b7": int8 [O]}."""
    raw = parse_memdata_header(header_path)
    params: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(cfg.layers):
        w = raw[f"weights_layer{i}"]
        assert w.shape == (layer.pe, layer.w_tiles, layer.simd), \
            (i, w.shape, (layer.pe, layer.w_tiles, layer.simd))
        params[f"w{i}"] = fold_to_dense(w, layer.out_ch, layer.in_ch,
                                        layer.kernel)
        b = raw[f"bias_layer{i}"]   # (1, OFM_CH, 1)
        assert b.shape == (1, layer.out_ch, 1)
        params[f"b{i}"] = b.reshape(layer.out_ch).astype(np.int8)
    return params


def save_checkpoint(path: str, params: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **params)


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
