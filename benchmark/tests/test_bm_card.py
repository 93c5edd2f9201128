"""A tiny cell through the card path, untraced and traced (card only:
``python -m pytest -m cuda benchmark/tests/test_bm_card.py`` on a machine
with one; it skips here)."""

import pytest

from benchmark import cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card, tiny, trace):
    c = tiny("ecoli_paf.ont_50kb")
    r = cell.run_cell(c, 11, 4.0, trace)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert r["device"]["busy_s"] > 0 and "breakdown" in r
        assert "k1_roofline_pct" in r["metrics"]
    else:
        assert set(r["metrics"]) == {"reads_per_s", "peak_mem_gib",
                                     "setup_s"}
