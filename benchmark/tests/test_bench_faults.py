"""The rest of a run, past the look for a card, with the timed path broken
underneath: ``correct`` must come out false for each fault a cell can
have.  (No cell spans cards, so no exchange between cards is left out.)"""

import time

import pytest

from conftest import small
from sicbench import harness
from simple_image_compression_network_tpu_torch.codec import pipeline


class _Altered:
    """A container with one payload byte changed where it is produced,
    from the window on (set-up's own batches come out sound, so that the
    run reaches its window)."""

    def __init__(self, after: int):
        self.calls, self.after = 0, after

    def __call__(self, blobs):
        self.calls += 1
        if self.calls <= self.after:
            return blobs
        bad = bytearray(blobs[0])
        bad[len(bad) // 2] ^= 0x21
        return [bytes(bad)] + blobs[1:]


def _half_left_out(x_hat):
    """Half of the batch left out: its outputs replaced by the rest's."""
    out = x_hat.clone()
    h = out.shape[0] // 2
    out[h:] = out[:h]
    return out


def _pixel_altered(x_hat):
    out = x_hat.clone()
    out.view(-1)[123] += 1
    return out


class _Stale:
    """A step that returns its state unchanged: every batch after the
    first comes back as the first one did."""

    def __init__(self):
        self.first = None

    def __call__(self, out):
        if self.first is None:
            self.first = out
        return self.first


FAULTS = {
    "container altered": ("encode", None),
    "image altered": ("decode", _pixel_altered),
    "half of the batch left out": ("decode", _half_left_out),
    "state unchanged": ("decode", None),
}
CELLS = {"int8_ref.bulk_b32": (pipeline.PipelinedEncoder,
                               pipeline.PipelinedDecoder, 64, 48),
         "hyper_scale.bulk_b8": (pipeline.HyperPipelinedEncoder,
                                 pipeline.HyperPipelinedDecoder, 128, 128)}


def _break(monkeypatch, cls, wrap, is_hyper_decode):
    finish = cls._finish

    def broken(self, state):
        out = finish(self, state)
        if is_hyper_decode:
            return (wrap(out[0]),) + tuple(out[1:])
        return wrap(out)
    monkeypatch.setattr(cls, "_finish", broken)


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", list(CELLS))
def test_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    enc, dec, h, w = CELLS[name]
    side, wrap = FAULTS[fault]
    cell = small(harness.Cell(name), height=h, width=w, sample_batches=4)
    if wrap is None:
        wrap = (_Altered(cell.mix["bank"] // cell.mix["batch"])
                if side == "encode" else _Stale())
    hyper = name.startswith("hyper")
    cls = enc if side == "encode" else dec
    _break(monkeypatch, cls, wrap, hyper and side == "decode")
    line = harness.run_cell(cell, 2**31 + 77, 0.8, False, "cpu",
                            time.perf_counter())
    assert line["correct"] is False, line["checks"]


def test_sound_run_is_correct():
    cell = small(harness.Cell("hyper_scale.bulk_b8"), height=128, width=128)
    line = harness.run_cell(cell, 2**31 + 78, 0.8, False, "cpu",
                            time.perf_counter())
    assert line["correct"] is True, line["checks"]
