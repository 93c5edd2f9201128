"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root (CPU; the test marked ``cuda`` skips without a card).
Tiny cells live under ``tiny/``: the same configurations on a 40 kb
genome, pools of 12 short reads, batches of 4."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


@pytest.fixture
def tiny():
    """A tiny cell of ``tiny/BENCHMARK.json`` by workload name."""
    from benchmark import cell

    def make(workload):
        return cell.Cell(workload,
                         spec_path=os.path.join(DATA, "BENCHMARK.json"),
                         traffic_dir=os.path.join(DATA, "traffic"))
    return make
