"""The readers of the program's spans (``sicbench/spans.py``): on a
hand-built stretch and hand-built spans in the program's recorder, each
metric's exact percentage and the logged busy and waiting time; device
idle under a ``wait`` span counted as no host step's; the spans taken from
the recorder once a run; a span beyond the windows by more than 1 ms, or a
program without a recorder, giving nothing."""

import pytest

from sicbench import harness, spans
from simple_image_compression_network_tpu_torch.utils import profiling

MS = 1_000_000
T_ENC = 1_790_000_000_000_000_000          # Unix-epoch ns, as recorded
T_DEC = T_ENC + 1000 * MS
METRICS = ["idle_in_host_pct.encode", "idle_in_host_pct.decode"]


class Stretch:
    def __init__(self, t0, busy):
        self.t0, self.t1, self._busy = t0, t0 + 100 * MS, busy

    def busy(self):
        return self._busy


class Ctx:
    def __init__(self, stretches):
        self.stretch = stretches


def recorder(*halves):
    """A recorder holding one batch's spans in each half that starts at
    the given ns: (name, start ms, end ms, parent, sizes), parents before
    their children."""
    rec = profiling.Recorder()
    for t0 in halves:
        base = len(rec.spans)
        for name, s, e, parent, sizes in [
                ("pipeline.schedule", 10, 45, None, {}),
                ("parse", 10, 20, 0, {}),
                ("upload", 25, 35, 0, {}),
                ("pin", 26, 28, 2, {"pinned_bytes": 4096}),
                ("enqueue", 35, 40, 0, {}),
                ("pipeline.finish", 45, 95, None, {}),
                ("wait", 45, 60, 5, {}),
                ("pack", 60, 90, 5, {}),
                ("wait", 70, 75, 7, {"refetches": 1})]:
            sp = profiling.Span()
            sp.name, sp.start_ns, sp.end_ns = name, t0 + s * MS, t0 + e * MS
            sp.parent = None if parent is None else rec.spans[base + parent]
            sp.sizes = sizes
            rec.spans.append(sp)
    return rec


def read_all(ctx):
    cell = harness.Cell("hyper_scale.bulk_b8")
    return {m: cell.reader(m).read(ctx) for m in METRICS}


@pytest.fixture
def ctx():
    # encode: the card idle 30-50 and 80-100 ms of the window; decode: busy
    # throughout
    return Ctx({"encode": Stretch(T_ENC, [(T_ENC, T_ENC + 30 * MS),
                                          (T_ENC + 50 * MS,
                                           T_ENC + 80 * MS)]),
                "decode": Stretch(T_DEC, [(T_DEC, T_DEC + 100 * MS)])})


def test_each_metric_reads_its_exact_share(ctx, monkeypatch, capsys):
    rec = recorder(T_ENC, T_DEC)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    got = read_all(ctx)
    # host work (innermost): schedule 20-25, 40-45; parse 10-20; upload
    # 25-26, 28-35; pin 26-28; enqueue 35-40; finish 90-95; pack 60-70,
    # 75-90: 65 ms.  Waiting 45-60, 70-75: 20 ms.  Idle 30-50 (upload 5,
    # enqueue 5, schedule 5, wait 5), 80-100 (pack 10, finish 5, outside
    # 5): 30 ms inside host steps, the 5 under a wait in none
    assert got == pytest.approx({"idle_in_host_pct.encode": 30.0,
                                 "idle_in_host_pct.decode": 0.0}, abs=1e-12)
    assert rec.spans == []              # taken once, for both halves
    for half in ("encode", "decode"):
        a = spans.analyse(ctx, half)
        assert (a["host_busy_ns"], a["host_wait_ns"]) == (65 * MS, 20 * MS)
    a = spans.analyse(ctx, "encode")
    assert a["idle_by_span"] == {
        "upload": 5 * MS, "enqueue": 5 * MS, "pipeline.schedule": 5 * MS,
        "wait": 5 * MS, "pack": 10 * MS, "pipeline.finish": 5 * MS,
        "outside": 5 * MS}
    assert (a["batches"], a["pinned_allocs"], a["pinned_bytes"],
            a["refetches"]) == (1, 1, 4096, 1)
    err = capsys.readouterr().err
    assert "encode: device idle 0.0400 s of 0.1000 s" in err
    assert "pack 0.0100 s" in err and "outside 0.0050 s" in err
    assert "decode: device idle 0.0000 s" in err
    assert "pinned allocations 1.00 a batch, 4096 bytes a batch" in err


@pytest.mark.parametrize("off_ms, read", [(0.5, True), (2.0, False)])
def test_a_span_beyond_the_windows_is_refused(ctx, monkeypatch, capsys,
                                              off_ms, read):
    rec = recorder(T_ENC, T_DEC)
    late = rec.spans[-1]
    late.end_ns = T_DEC + 100 * MS + int(off_ms * MS)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    got = read_all(ctx)
    if read:
        assert None not in got.values()
    else:
        assert set(got.values()) == {None}
        assert "outside every traced window" in capsys.readouterr().err


def test_a_program_without_spans_gives_nothing(ctx, monkeypatch, capsys):
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    assert set(read_all(ctx).values()) == {None}
    assert "recorded no spans" in capsys.readouterr().err
    monkeypatch.delattr(profiling, "RECORDER")
    assert set(read_all(Ctx(ctx.stretch)).values()) == {None}


def test_innermost_and_idle_edges():
    assert spans.innermost([(0, 10, "a"), (0, 10, "b"), (2, 4, "c")]) == [
        (0, 2, "b"), (2, 4, "c"), (4, 10, "b")]
    assert spans.idle(0, 10, [(-5, 2), (3, 4), (9, 12)]) == [(2, 3), (4, 9)]
    assert spans.idle(0, 10, []) == [(0, 10)]
