"""The port's span recorder (``utils/profiling.py``) on the CPU: off
outside a profiler session, nesting inside one, each thread's own nesting,
the profiler's own clock, no profiler event named after a program span,
and the spans that the int8 and hyper pipelines record (at the shapes of
``tests/test_torch_pipeline.py``'s fixtures, built from the port alone)."""

import contextlib
import os
import statistics
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from simple_image_compression_network_tpu_torch.codec import (
    hyper_codec, int_codec, pipeline)
from simple_image_compression_network_tpu_torch.models import (
    codec_int, hyperprior)
from simple_image_compression_network_tpu_torch.utils import profiling

torch.set_num_threads(1)

REC = profiling.RECORDER
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "reference_weights.npz")


@pytest.fixture(scope="module")
def setup():
    """Three seeded 128x64 batches of two, the int8 net with static CDFs
    fitted on them, and its sync containers."""
    rng = np.random.default_rng(5)
    xs = [rng.integers(0, 256, size=(2, 128, 64, 3), dtype=np.uint8)
          for _ in range(3)]
    net = codec_int.IntCodecNet.from_checkpoint(CKPT, device="cpu")
    cdfs = int_codec.build_static_cdfs(net, [x[:1] for x in xs])
    sync = [int_codec.compress_batch(net, torch.from_numpy(x),
                                     static_cdfs=cdfs) for x in xs]
    return dict(xs=xs, cdfs=cdfs, net=net, sync=sync)


@pytest.fixture(scope="module")
def hyper():
    """The n = 8, m = 12 scale model, seeded, its codec, three seeded
    128x128 batches of two and their sync containers."""
    torch.manual_seed(0)
    codec = hyper_codec.HyperCodec(
        hyperprior.ScaleHyperprior(n=8, m=12, device="cpu"))
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.random((2, 128, 128, 3), np.float32))
          for _ in range(3)]
    return dict(codec=codec, xs=xs,
                sync=[codec.compress_batch(x) for x in xs])


def cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_is_one_shared_noop_that_records_and_allocates_nothing():
    assert not torch._C._autograd._profiler_enabled()
    REC.take()
    a = profiling.span("pipeline.schedule")
    b = profiling.span("wait", refetches=1)
    assert a is b is profiling._OFF

    def loop(k):
        for _ in range(k):
            with profiling.span("pipeline.schedule"):
                with profiling.span("pin", pinned_bytes=64):
                    pass

    loop(10)
    tracemalloc.start()
    try:
        grown = []
        for k in (1000, 10000):
            tracemalloc.reset_peak()
            before = tracemalloc.get_traced_memory()[0]
            loop(k)
            now, peak = tracemalloc.get_traced_memory()
            grown.append((now - before, peak - before))
    finally:
        tracemalloc.stop()
    # nothing kept, and no transient that grows with the calls
    assert [g[0] for g in grown] == [0, 0]
    assert grown[0][1] == grown[1][1] < 1024
    assert REC.take() == []


def test_spans_nest_inside_a_profiler_session():
    REC.take()
    with cpu_session():
        with profiling.span("pipeline.schedule") as root:
            assert root is not profiling._OFF
            with profiling.span("upload"):
                with profiling.span("pin", pinned_bytes=4096):
                    torch.ones(8)
            with profiling.span("enqueue"):
                pass
        with profiling.span("pipeline.finish"):
            with profiling.span("wait"):
                pass
        with profiling.span("parse"):
            pass
    assert profiling.span("after") is profiling._OFF
    got = REC.take()
    names = [s.name for s in got]
    parents = [None if s.parent is None else names[got.index(s.parent)]
               for s in got]
    assert list(zip(names, parents)) == [
        ("pipeline.schedule", None), ("upload", "pipeline.schedule"),
        ("pin", "upload"), ("enqueue", "pipeline.schedule"),
        ("pipeline.finish", None), ("wait", "pipeline.finish"),
        ("parse", None)]
    assert got[2].sizes == {"pinned_bytes": 4096} and got[1].sizes == {}
    for s in got:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = s.parent
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert REC.take() == []             # taken spans are forgotten


def test_each_thread_nests_its_own_spans():
    """Two threads open their spans in turns on one recorder: each span's
    parent is its own thread's, and each closes without disturbing the
    other's stack."""
    rec = profiling.Recorder()
    turn = threading.Barrier(2)
    out = {}

    def run(k):
        with rec.open(f"outer{k}", {}) as outer:
            turn.wait()
            with rec.open(f"inner{k}", {}) as inner:
                turn.wait()
            turn.wait()
        out[k] = (outer, inner)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, (outer, inner) in out.items():
        assert outer.parent is None and inner.parent is outer
        assert outer.end_ns is not None and inner.end_ns is not None
    assert len(rec.take()) == 4 and rec.spans == []


def test_spans_share_the_profilers_clock():
    """A span opened around a ``record_function`` range starts and ends
    within 50 us of the range's kineto stamps, and the profile holds no
    event named after a program span."""
    REC.take()
    with cpu_session() as prof:
        for i in range(12):
            with profiling.span(f"clock{i}"):
                with record_function(f"range{i}"):
                    torch.ones(16).sum()
    spans = {s.name: s for s in REC.take()}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert not set(spans) & set(events)
    lead, lag = [], []
    for i in range(2, 12):                  # the first calls warm up
        s, e = spans[f"clock{i}"], events[f"range{i}"]
        lead.append(e.start_ns() - s.start_ns)
        lag.append(s.end_ns - e.end_ns())
        assert -1_000_000 < lead[-1] < 1_000_000, lead
    assert 0 <= statistics.median(lead) < 50_000, lead
    assert 0 <= statistics.median(lag) < 50_000, lag


def batches(spans):
    """The names of the spans inside each ``pipeline.schedule`` and each
    ``pipeline.finish``, in the order the roots opened: the n-th finish is
    the n-th schedule's batch."""
    out = {"pipeline.schedule": [], "pipeline.finish": []}
    inside = {}
    for s in spans:
        root = s
        while root.parent is not None:
            root = root.parent
        if root is s and s.name in out:
            inside[id(s)] = []
            out[s.name].append(inside[id(s)])
        elif root is not s and id(root) in inside:
            inside[id(root)].append(s.name)
    return out


def test_int8_pipelines_record_each_batch(setup):
    REC.take()
    with cpu_session():
        enc = pipeline.PipelinedEncoder(setup["net"], setup["cdfs"], depth=2)
        for x in setup["xs"]:
            enc.submit(torch.from_numpy(x))
        blobs = enc.drain()
        encoded = batches(REC.take())
        dec = pipeline.PipelinedDecoder(setup["net"], setup["cdfs"], depth=2)
        for b in blobs:
            dec.submit(b)
        dec.drain()
    decoded = batches(REC.take())
    assert blobs == setup["sync"]
    assert encoded == {"pipeline.schedule": [["enqueue"]] * 3,
                       "pipeline.finish": [["wait", "pack"]] * 3}
    assert decoded == {
        "pipeline.schedule": [["parse", "stage", "upload", "enqueue"]] * 3,
        "pipeline.finish": [["wait"]] * 3}


def test_int8_refetch_is_a_wait_and_counted(setup):
    REC.take()
    with cpu_session():
        enc = pipeline.PipelinedEncoder(setup["net"], setup["cdfs"], depth=2)
        enc._mxb = 1
        enc.submit(torch.from_numpy(setup["xs"][0]))
        assert enc.drain() == [setup["sync"][0]]
    waits = [s for s in REC.take()
             if s.name == "wait" and s.sizes.get("refetches")]
    assert len(waits) == 1 and waits[0].sizes == {"refetches": 1}
    assert waits[0].parent.name == "pipeline.finish"


def test_hyper_pipelines_record_each_batch(hyper):
    REC.take()
    with cpu_session():
        enc = pipeline.HyperPipelinedEncoder(hyper["codec"], depth=2)
        for x in hyper["xs"]:
            enc.submit(x)
        blobs = enc.drain()
        encoded = batches(REC.take())
        dec = pipeline.HyperPipelinedDecoder(hyper["codec"], depth=2)
        for b in blobs:
            dec.submit(b)
        dec.drain()
    decoded = batches(REC.take())
    assert blobs == hyper["sync"]
    assert encoded["pipeline.schedule"] == [["enqueue"]] * 3
    assert len(encoded["pipeline.finish"]) == 3
    for inside in encoded["pipeline.finish"]:
        assert inside[0] == "wait" and "pack" in inside
    assert len(decoded["pipeline.schedule"]) == 3
    for inside in decoded["pipeline.schedule"]:
        assert inside[:4] == ["parse", "stage", "upload", "enqueue"]
    assert decoded["pipeline.finish"] == [["wait"]] * 3


@pytest.mark.parametrize("on", [False, True])
def test_a_failing_batch_leaves_no_span_open(setup, on):
    """A corrupt container raises out of its finish; the recorder's stack
    unwinds, so later spans are roots again."""
    blobs = list(setup["sync"][0])
    bad = bytearray(blobs[-1])
    bad[-3] ^= 0xFF
    REC.take()
    with cpu_session() if on else contextlib.nullcontext():
        dec = pipeline.PipelinedDecoder(setup["net"], setup["cdfs"], depth=1)
        dec.submit(blobs[:-1] + [bytes(bad)])
        with pytest.raises(ValueError, match="corrupt"):
            dec.drain()
        with profiling.span("after"):
            pass
    assert not getattr(REC._local, "stack", [])
    after = [s for s in REC.take() if s.name == "after"]
    assert len(after) == on and all(s.parent is None for s in after)
