"""The port's process runtime (``parallel/distributed.py``) with real ranks:
processes on the CPU over gloo.

Two ranks rendezvous through ``initialize_multihost`` (torch's environment
names) and all-reduce; a missing rank makes the rendezvous raise within its
timeout; ``barrier`` raises within its own; ``spawn_ranks`` returns each
rank's result, fails with the traceback of a rank that raises, fails a call
that outlasts its bound, and leaves no process behind.  Every spawn and
every join is bounded."""

import multiprocessing
import os
import socket
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from simple_image_compression_network_tpu_torch.parallel import (
    distributed, mesh as meshlib)

JOIN_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _group_body() -> dict:
    """One rank of a spawned pair: a collective, the helpers, a barrier
    that both pass and one that rank 1 skips."""
    rank = dist.get_rank()
    t = torch.tensor([rank + 1])
    dist.all_reduce(t)
    out = {"sum": int(t), "primary": distributed.is_primary(),
           "ranks": distributed.global_mesh_devices(),
           "neighbours": meshlib.spatial_mesh(device="cpu").neighbours("x")}
    distributed.barrier("both", timeout_s=60)
    distributed.barrier("both", timeout_s=60)   # a name may be reused
    if rank == 0:
        t0 = time.monotonic()
        try:
            distributed.barrier("alone", timeout_s=2)
            out["alone"] = None
        except RuntimeError as e:
            out["alone"] = (str(e), time.monotonic() - t0)
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) == 1:
            raise RuntimeError("transient")
        return "done"

    out["retry"] = (distributed.run_with_retry(flaky, backoff_s=0.01),
                    len(tries))
    return out


@pytest.fixture(scope="module")
def pair():
    return distributed.spawn_ranks(_group_body, 2, backend="gloo",
                                   device="cpu", timeout_s=JOIN_S)


def test_spawned_ranks_all_reduce_and_know_their_place(pair):
    assert [r["sum"] for r in pair] == [3, 3]
    assert [r["primary"] for r in pair] == [True, False]
    assert [r["ranks"] for r in pair] == [[0, 1], [0, 1]]
    assert [r["neighbours"] for r in pair] == [(None, 1), (0, None)]


def test_barrier_raises_within_its_timeout(pair):
    msg, waited = pair[0]["alone"]
    assert "timeout" in msg.lower()
    assert 1.5 < waited < 30


def test_run_with_retry_runs_again_after_a_failure(pair):
    assert [r["retry"] for r in pair] == [("done", 2), ("done", 2)]


def _multihost(rank: int, port: int, missing_port: int, results) -> None:
    """A rank started by hand: rendezvous through torch's environment
    names, all-reduce, leave; then rank 0 waits for a peer that never
    comes."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank))
    try:
        assert distributed.initialize_multihost(init_timeout=60)
        t = torch.tensor([10 * (rank + 1)])
        dist.all_reduce(t)
        dist.destroy_process_group()
        out = {"sum": int(t)}
        if rank == 0:
            t0 = time.monotonic()
            try:
                distributed.initialize_multihost(
                    f"127.0.0.1:{missing_port}", 2, 0, init_timeout=5)
                out["missing"] = None
            except Exception as e:  # the error type varies by torch version
                out["missing"] = (type(e).__name__,
                                  time.monotonic() - t0)
        results.put((rank, out))
    except BaseException as e:
        results.put((rank, repr(e)))


def test_initialize_multihost_rendezvous_and_a_missing_rank():
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port, missing = _free_port(), _free_port()
    procs = [ctx.Process(target=_multihost, daemon=True,
                         args=(r, port, missing, results)) for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=JOIN_S) for _ in procs)
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
    assert got[0]["sum"] == got[1]["sum"] == 30, got
    assert got[0]["missing"] is not None, "the rendezvous did not raise"
    assert got[0]["missing"][1] < 30, got[0]
    assert not any(p.is_alive() for p in procs)


def test_no_coordinator_means_one_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert not distributed.initialize_multihost(None)
    assert distributed.is_primary()
    assert distributed.global_mesh_devices() == [0]
    distributed.barrier("noop")     # no group: nothing to wait for
    assert distributed.run_with_retry(lambda: 7) == 7


def _rank_one_raises() -> None:
    if dist.get_rank() == 1:
        raise ValueError("rank one gives up")
    time.sleep(60)


def _hangs() -> None:
    time.sleep(60)


def test_a_rank_that_raises_fails_the_call_and_stops_the_others():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        distributed.spawn_ranks(_rank_one_raises, 2, backend="gloo",
                                device="cpu", timeout_s=JOIN_S)
    assert "ValueError: rank one gives up" in str(err.value)
    assert time.monotonic() - t0 < 45
    assert not multiprocessing.active_children()


def test_a_call_that_outlasts_its_bound_fails_and_stops_the_ranks():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0\] did not finish"):
        distributed.spawn_ranks(_hangs, 1, backend="gloo", device="cpu",
                                timeout_s=3)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()
