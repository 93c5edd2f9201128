"""A whole run of a tiny cell on the CPU, the card check skipped: sound, it
comes out correct; with the timed path broken underneath, not correct.
The faults a mapping cell can have: an answer altered where it is made;
half of each batch left out; a batch that returns the previous batch's
answers (its state unchanged).  No cell runs on several cards, so the
exchange between them has no fault here."""

import dataclasses

import pytest
import torch

from benchmark import cell


def _altered(mapper):
    real = mapper.map_batch

    def wrong(seqs):
        out = list(real(seqs))
        for i, r in enumerate(out):
            if r.mapped:
                out[i] = dataclasses.replace(r, score=r.score + 1)
                break
        return out
    mapper.map_batch = wrong


def _half_left_out(mapper):
    from bioinfo1_tpu_torch.pipeline.mapper import ReadMapping
    real = mapper.map_batch

    def half(seqs):
        out = list(real(seqs[:len(seqs) // 2]))
        return out + [ReadMapping(mapped=False)] * (len(seqs) - len(out))
    mapper.map_batch = half


def _unchanged(mapper):
    real = mapper.map_batch
    last = []

    def stale(seqs):
        if not last:
            last.append(list(real(seqs)))
        prev = last[0]
        return (prev * (len(seqs) // len(prev) + 1))[:len(seqs)]
    mapper.map_batch = stale


def _run(tiny, workload, fault=None, seconds=10.0):
    c = tiny(workload)
    return cell.run_cell(c, 2 ** 31 + 77, seconds, False,
                         devices=[torch.device("cpu")] * c.chips,
                         break_path=fault)


def test_sound_run_is_correct(tiny):
    r = _run(tiny, "ecoli_paf.ont_50kb")
    assert r["correct"], r["check"]
    assert r["check"]["compared_rows"]["value"] >= 2
    assert r["failed"] == 0 and r["attempted"] >= r["counts"][
        "reads_in_window"] > 0
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}


@pytest.mark.parametrize("workload", ["ecoli_paf.ont_2_8kb",
                                      "ecoli_paf.ont_50kb"])
@pytest.mark.parametrize("fault", [_altered, _half_left_out, _unchanged])
def test_broken_path_is_not_correct(tiny, fault, workload):
    r = _run(tiny, workload, fault)
    assert not r["correct"]
    assert r["check"]["differing_rows"]["value"] > 0

