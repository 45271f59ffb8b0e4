"""Training checkpoints and resume, in the JAX package's format.

The port of the JAX package's ``utils/train_ckpt.py``.  A checkpoint is
what ``flax.serialization.to_bytes`` writes for ``{"step", "params",
"opt_state"}``: msgpack (``utils/msgpack_io.py``) with the parameters as
the flax tree ``{"params": {...}}`` (``weights_io.hyper_params_to_jax``)
and the optimizer state as optax's ``chain(clip_by_global_norm, adam)``
state ``{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {}}}``, the
moments as flax trees of the parameters' names.  So either package resumes
the other's checkpoints, and ``eval_codec --ckpt`` serves them.
``save_params`` / ``restore_params`` take the tree map: the hyperprior's by
default, ``intnet.intnet_params_to_jax`` / ``intnet_params_from_jax`` for
the integer net's shadow weights (``train_intnet``'s ``<out>.msgpack``).

Writes go to a temporary file that is renamed over the target, so an
interrupted save never corrupts the latest checkpoint.  ``restore`` takes
templates (a fresh model's ``state_dict`` and optimizer state) and raises
``ValueError`` on any missing, extra, reshaped or retyped leaf: it never
drops one silently.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import msgpack_io, weights_io


def _write_atomic(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _opt_tree(state: Any) -> dict:
    """An ``AdamState`` (count, mu, nu) -> optax's chain state as flax
    writes it."""
    return {"0": {}, "1": {"0": {
        "count": np.asarray(state.count, np.int32),
        "mu": weights_io.hyper_params_to_jax(state.mu),
        "nu": weights_io.hyper_params_to_jax(state.nu)}, "1": {}}}


def _check(want: Any, got: Any, path: str) -> None:
    """Raise ValueError unless ``got`` has ``want``'s keys at every level
    and, at each array leaf, its shape and dtype."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise ValueError(f"{path}: a leaf where the template has a map")
        missing, extra = set(want) - set(got), set(got) - set(want)
        if missing or extra:
            raise ValueError(f"{path}: missing {sorted(missing)}, extra "
                             f"{sorted(extra)}")
        for k in want:
            _check(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        if (not isinstance(got, np.ndarray) or got.shape != want.shape
                or got.dtype != want.dtype):
            desc = (f"{got.dtype}{list(got.shape)}"
                    if isinstance(got, np.ndarray) else type(got).__name__)
            raise ValueError(f"{path}: {desc} where the template has "
                             f"{want.dtype}{list(want.shape)}")
    elif not isinstance(got, type(want)):
        raise ValueError(f"{path}: {type(got).__name__} where the template "
                         f"has {type(want).__name__}")


def _like(template: Dict[str, torch.Tensor], tree: dict,
          from_jax: Callable = weights_io.hyper_params_from_jax
          ) -> Dict[str, torch.Tensor]:
    """A flax tree -> tensors named, placed and typed as ``template``."""
    state = from_jax(tree)
    return {k: state[k].to(device=t.device, dtype=t.dtype)
            for k, t in template.items()}


def save(path: str, step: int, params: Dict[str, torch.Tensor],
         opt_state: Any) -> None:
    """Write ``{"step", "params", "opt_state"}`` to ``path``: ``params`` a
    model's ``state_dict``, ``opt_state`` a ``train.AdamState``."""
    payload = {"step": int(step),
               "params": weights_io.hyper_params_to_jax(params),
               "opt_state": _opt_tree(opt_state)}
    _write_atomic(path, msgpack_io.dumps(payload))


def restore(path: str, params_template: Dict[str, torch.Tensor],
            opt_state_template: Any) -> Tuple[int, Dict[str, torch.Tensor],
                                              Any]:
    """-> (step, params, opt_state) from ``path``, each leaf checked
    against the templates and placed on their devices."""
    tree = msgpack_io.load(path)
    _check({"step": 0, "params": weights_io.hyper_params_to_jax(
        params_template), "opt_state": _opt_tree(opt_state_template)},
        tree, path)
    adam = tree["opt_state"]["1"]["0"]
    opt_state = type(opt_state_template)(
        int(adam["count"]), _like(opt_state_template.mu, adam["mu"]),
        _like(opt_state_template.nu, adam["nu"]))
    return (tree["step"], _like(params_template, tree["params"]),
            opt_state)


def save_params(path: str, params: Dict[str, torch.Tensor],
                to_jax: Callable = weights_io.hyper_params_to_jax) -> None:
    """A params-only checkpoint ``{"params": to_jax(params)}``: with the
    hyperprior's tree map (the default), what a model release ships
    (``*.params.msgpack``, read by the serving models'
    ``from_checkpoint``); with ``intnet.intnet_params_to_jax``, the
    integer net's shadow weights as the JAX package's ``train_intnet``
    writes them."""
    payload = {"params": to_jax(params)}
    _write_atomic(path, msgpack_io.dumps(payload))


def restore_params(path: str, params_template: Dict[str, torch.Tensor],
                   to_jax: Callable = weights_io.hyper_params_to_jax,
                   from_jax: Callable = weights_io.hyper_params_from_jax
                   ) -> Dict[str, torch.Tensor]:
    """The inverse of ``save_params`` under the same tree map, each leaf
    checked against ``params_template``'s (``to_jax`` of it)."""
    tree = msgpack_io.load(path)
    _check({"params": to_jax(params_template)}, tree, path)
    return _like(params_template, tree["params"], from_jax)


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """The checkpoint of ``directory`` with the highest step (numeric
    order: ckpt_10 after ckpt_9), or None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(re.escape(prefix) + r"(\d+)\.msgpack")
    steps = [(int(m.group(1)), f) for f in os.listdir(directory)
             if (m := pat.fullmatch(f))]
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])
