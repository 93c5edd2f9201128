"""The check's control (the reference with its DP held to the control's
band, no certificate) comes out not correct, at a size a test run holds:
8 kb reads drift past 128 lanes; the reference against itself comes out
correct."""

import pytest
import torch

from benchmark import cell, control, simulate


def _small(tiny, workload):
    c = tiny(workload)
    c.traffic = dict(c.traffic, pool_reads=6, check_reads=6,
                     classes=[{"share": 1.0, "lo": 8000, "hi": 8000}])
    return c


@pytest.mark.parametrize("workload", ["ecoli_paf.ont_2_8kb",
                                      "ecoli_paf.ont_50kb"])
def test_control_is_not_correct(tiny, workload):
    r = control.reading(_small(tiny, workload), 2 ** 31 + 9,
                        torch.device("cpu"))
    assert not r["_correct"]
    assert r["differing_rows"]["value"] > 0
    assert r["compared_rows"]["value"] == 6


def test_reference_against_itself_is_correct(tiny):
    c = _small(tiny, "ecoli_paf.ont_2_8kb")
    g = simulate.make_genome(c.config["genome"], 1)
    pool = [s for _, s in simulate.make_pool(g, c.traffic,
                                             simulate.rng_for(1, 1))]
    pick = cell.sample(c, 1, pool, 2 * len(pool))
    assert len(pick) == 6 and pick[0] == max(range(6),
                                             key=lambda p: len(pool[p]))
    rows = cell.reference_rows(c, g, pool, pick, torch.device("cpu"))
    lines = [f"r{p}.{k}\t{rows[p]}" for k in range(2) for p in pick
             if rows[p] is not None]
    r = cell.compare(rows, lines, 2 * len(pool), len(pool))
    assert r["_correct"] and r["compared_rows"]["value"] == 12
