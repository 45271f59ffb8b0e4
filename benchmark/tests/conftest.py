"""The benchmark's own tests: the harness, its yardstick and its plain
reference on the host at small sizes, and (marked ``card``) the control
at the cells' own sizes on the card.

    JAX_PLATFORMS=cpu python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(BENCH, "reference"), BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips on a host without one")


@pytest.fixture
def card():
    """Skip (inside the test) where there is no card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def small(cell, **kw):
    """A cell's mix cut to a host-sized bank and geometry."""
    cell.mix.update(dict(bank=4, batch=2, sample_batches=2), **kw)
    return cell
