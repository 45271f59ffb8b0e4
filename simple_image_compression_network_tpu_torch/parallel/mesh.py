"""Rank meshes over the default ``torch.distributed`` process group.

The counterpart of the JAX package's ``parallel/mesh.py``.  JAX's mesh is
an array of devices under one controller; here each rank is a process (SPMD)
and the mesh is the row-major grid of the group's ranks, as
``np.array(devices).reshape(shape)`` orders devices.  A rank's ``Mesh``
knows the grid's shape and axis names, its own coordinates, its neighbours
along each axis and the device it computes on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


class Mesh(NamedTuple):
    """This rank's view of the rank grid."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    backend: str

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coords(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The grid coordinates of ``rank`` (this rank by default)."""
        r = self.rank if rank is None else rank
        return tuple(int(c) for c in np.unravel_index(r, self.shape))

    def coord(self, axis: str) -> int:
        return self.coords()[self.axis_names.index(axis)]

    def neighbours(self, axis: str) -> Tuple[Optional[int], Optional[int]]:
        """The ranks one step below and above along ``axis`` (None past the
        grid's ends)."""
        k = self.axis_names.index(axis)
        c = list(self.coords())
        out = []
        for step in (-1, 1):
            if 0 <= c[k] + step < self.shape[k]:
                nb = list(c)
                nb[k] += step
                out.append(int(np.ravel_multi_index(nb, self.shape)))
            else:
                out.append(None)
        return out[0], out[1]

    @property
    def staged(self) -> bool:
        """Whether messages pass through host memory: gloo moves host
        tensors only, NCCL device tensors."""
        return self.backend != "nccl" and self.device.type == "cuda"

    @property
    def comm_device(self) -> torch.device:
        """The device the backend's collectives take tensors on."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_mesh(shape: Tuple[int, ...], axis_names: Sequence[str],
              device=None) -> Mesh:
    """The mesh of ``shape`` over every rank of the default process group.

    ``device``: this rank's device (``utils/device.py:resolve_device``:
    None is the current CUDA device, and raises without a card).  Raises
    without an initialized process group, and when the group's size is
    not ``prod(shape)``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "distributed.spawn_ranks or initialize_multihost")
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} mesh dims for axes {axis_names}")
    n, world = int(np.prod(shape)), dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    if world > n:
        raise ValueError(f"a mesh spans every rank: {n} of {world}")
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device on each rank")
    return Mesh(shape, tuple(axis_names), dist.get_rank(), dev, backend)


def spatial_mesh(n_ranks: int | None = None, device=None) -> Mesh:
    """1-D mesh over the image X axis (spatial tiling)."""
    if n_ranks is None and dist.is_initialized():
        n_ranks = dist.get_world_size()
    return make_mesh((n_ranks or 1,), ("x",), device)
