"""The control: the reference in the program's place one precision below
the configuration's must fail one of the cell's limits.  The int8 control
(int4 activations) fails on the host at a small size; TF32, the float32
cells' control, exists on the card alone, where it runs at the cell's own
size on three seeds."""

import json
import os

import pytest

import control
from conftest import ROOT, small
from sicbench import harness

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


def test_int8_control_fails_at_a_small_size():
    cell = small(harness.Cell("int8_ref.bulk_b32"), height=64, width=48)
    got = control.readings(cell, 2**31 + 3, "cpu")
    assert set(control.failed(cell, got)) == {"z_mismatch", "x_mismatch"}


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = harness.Cell(name)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        assert control.failed(cell, control.readings(cell, seed, card))
