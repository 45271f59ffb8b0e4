"""Ranks as processes: rendezvous, bounded barriers, retry, and a spawner.

The counterpart of the JAX package's ``parallel/distributed.py``.  JAX runs
one controller per host; the port runs one process per rank (SPMD), each
holding its own tile and making the same collectives through
``torch.distributed``.  The backend is the caller's choice and nothing
switches it: ``"nccl"`` when each rank has a card of its own, ``"gloo"``
when ranks share one card or run on the CPU (NCCL refuses two ranks on one
card).

Failure story, as in the JAX package:

* detection: ``initialize_multihost`` bounds the rendezvous with
  ``init_timeout``, and ``barrier`` bounds a sync point mid-run, on every
  backend (it waits on the process group's store, not on a collective);
  ``spawn_ranks`` fails the call with the traceback of a rank that raised,
  and stops every rank when one fails or the call outlasts its bound;
* recovery: codec work units are idempotent (one image -> one bitstream),
  so ``run_with_retry`` may run a failed unit again.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, TypeVar

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device

T = TypeVar("T")
_barriers: dict = {}    # name -> times this process has passed it


def _timeout(seconds: Optional[float]) -> Optional[datetime.timedelta]:
    return None if seconds is None else datetime.timedelta(seconds=seconds)


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         init_timeout: Optional[float] = None,
                         backend: str = "gloo") -> bool:
    """Initialize the default process group from the arguments or torch's
    environment names (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  Returns False with no coordinator (one process), else True.

    ``coordinator``: "host:port" of rank 0's store, or an init method URL
    ("tcp://...", "file://...").  ``init_timeout`` (seconds) bounds the
    rendezvous: a rank that never arrives makes this raise instead of
    hang."""
    if not coordinator and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout(init_timeout))
    return True


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh_devices() -> List[int]:
    """Every rank of the group, in the order a mesh lays them out (the
    port's meshes are over ranks; each rank names its own device)."""
    return list(range(dist.get_world_size() if dist.is_initialized()
                      else 1))


def barrier(name: str, timeout_s: float = 60.0) -> None:
    """Sync point with a bounded wait: raises on a rank that waits more
    than ``timeout_s`` for the others (a dead rank is noticed at the next
    barrier, not never).  It waits on the process group's store, so it is
    bounded on every backend (``dist.monitored_barrier`` exists on gloo
    only).  Every rank must pass the barriers in the same order."""
    if not dist.is_initialized():
        return  # one process
    turn = _barriers.get(name, 0)
    _barriers[name] = turn + 1
    store = dist.distributed_c10d._get_default_store()
    key = f"sicn_barrier/{name}/{turn}"
    store.set(f"{key}/{dist.get_rank()}", b"1")
    store.wait([f"{key}/{r}" for r in range(dist.get_world_size())],
               datetime.timedelta(seconds=timeout_s))


def run_with_retry(fn: Callable[[], T], max_retries: int = 2,
                   backoff_s: float = 0.5,
                   retry_on: tuple = (Exception,)) -> T:
    """Run an IDEMPOTENT work unit, retrying on transient failure.

    The codec's units (one image -> one bitstream; one bitstream -> one
    reconstruction) are stateless and repeatable, so re-running after a
    communication or device failure is always safe."""
    err: Optional[BaseException] = None
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203
            err = e
            if attempt < max_retries:
                time.sleep(backoff_s * (2 ** attempt))
    raise err  # type: ignore[misc]


def _rank_main(fn, rank: int, n: int, backend: str, device: str,
               store_path: str, timeout_s: float, args: tuple,
               results) -> None:
    """One spawned rank: join the group through the file store, run
    ``fn(*args)``, report (rank, ok, result or traceback)."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count()
                                  if backend == "nccl" else dev)
        dist.init_process_group(backend,
                                store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n,
                                timeout=_timeout(timeout_s))
        try:
            out = (rank, True, fn(*args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        out = (rank, False, traceback.format_exc())
    results.put(out)


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]     # the started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def _take(got: dict, item: tuple, n: int) -> None:
    rank, ok, value = item
    if not ok:
        raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
    got[rank] = value


def _after_silence(procs, got: dict, results, deadline: float,
                   timeout_s: float):
    """When no report came: raise if a rank died without reporting or the
    call is past its bound, else None.  The report of a rank that has just
    exited may still be in flight: it is returned if it comes within a
    second."""
    dead = [r for r, p in enumerate(procs)
            if r not in got and p.exitcode is not None]
    if dead:
        try:
            return results.get(timeout=1.0)
        except queue.Empty:
            raise RuntimeError(f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} before "
                               f"reporting") from None
    if time.monotonic() > deadline:
        raise TimeoutError(f"ranks {sorted(set(range(len(procs))) - set(got))}"
                           f" did not finish within {timeout_s} s")
    return None


def spawn_ranks(fn: Callable[..., T], n: int, *, backend: str,
                device=None, timeout_s: float = 120.0,
                args: tuple = ()) -> List[T]:
    """Run ``fn(*args)`` on ``n`` new processes, one rank each, and return
    their results in rank order.

    The processes start with ``torch.multiprocessing``'s spawn method (so
    ``fn`` must be importable by name, and its results picklable host
    objects: numpy arrays, bytes, numbers) and meet through a
    ``FileStore`` in a fresh temporary directory, which no two calls
    share.  ``device``: each rank's device (``resolve_device``: None is
    the card, and raises without one); under ``"nccl"`` rank r takes card
    r.  A rank that raises fails the call with its traceback; a call that
    outlasts ``timeout_s`` fails too; either way every rank is stopped and
    no partial result is returned.  Build the CUDA kernels before calling
    this, so that the ranks find the library instead of each running the
    compiler."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and (dev.type != "cuda"
                              or n > torch.cuda.device_count()):
        raise ValueError(f"nccl needs a card for each of the {n} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="sicn_ranks_")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, backend, str(dev),
                               os.path.join(tmp, "store"), timeout_s, args,
                               results))
             for r in range(n)]
    got: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < n:
            try:
                item = results.get(timeout=0.2)
            except queue.Empty:
                item = _after_silence(procs, got, results, deadline,
                                      timeout_s)
            if item is not None:
                _take(got, item, n)
        for p in procs:
            p.join(30)
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(n)]
