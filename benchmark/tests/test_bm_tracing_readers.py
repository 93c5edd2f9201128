"""The readers of the program's batch records (``fused_cpu_ms_per_batch``,
``fused_offcpu_pct``, ``launches_per_batch``) on a hand-made trace and
records: only the batches wholly inside the stretch count, no batch (or a
program that keeps no records) reads None, and a CPU trace gives no
launches.  Then a tiny traced run on the CPU reports the two
``program_span`` metrics."""

import collections
import json
import os

import pytest
import torch

from benchmark import cell, tracefile
from bioinfo1_tpu_torch.utils import tracing
from conftest import ROOT

NAMES = ("fused_cpu_ms_per_batch", "fused_offcpu_pct", "launches_per_batch")


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _record(bid, tid, pack, step, adapt, fused_cpu):
    """A record whose fused.* spans are (wall ns, cpu ns) pairs."""
    rec = tracing.BatchRecord(id=bid, thread=tid, reads=4, t0_ns=1)
    for name, (wall, cpu) in (("fused.pack", pack), ("fused.step", step),
                              ("fused.adapt", adapt),
                              ("fused.upload", (10 ** 6, 0)),
                              ("fused", (10 ** 7, fused_cpu))):
        rec.spans[name] = tracing.SpanTotals(calls=1, wall_ns=wall,
                                             cpu_ns=cpu, self_cpu_ns=cpu)
    return rec


def _ctx(tmp_path, events):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    ctx = cell.Context()
    ctx.trace = tracefile.Trace(str(p), main_tid=1)
    return ctx


def _read(ctx):
    c = cell.Cell("ecoli_paf.ont_2_8kb")
    return {n: c.reader(n).read(ctx) for n in NAMES}


@pytest.fixture
def records(monkeypatch):
    recs = collections.deque([
        _record(7, 2, (100, 80), (1000, 400), (100, 20), 3_000_000),
        _record(8, 3, (100, 100), (100, 100), (100, 100), 9_000_000),
        _record(9, 2, (1, 1), (1, 1), (1, 1), 1)])
    monkeypatch.setattr(tracing, "batches", recs)
    return recs


def _events(with_runtime=True):
    ev = [
        _x("user_annotation", "bm.stretch", 9, 100.0, 1000.0),
        _x("user_annotation", "batch#7", 2, 150.0, 300.0),     # inside
        _x("user_annotation", "map_batch", 2, 151.0, 298.0),
        _x("user_annotation", "batch#8", 3, 50.0, 200.0),      # straddles
        _x("user_annotation", "batch#9", 2, 1000.0, 200.0),    # straddles
        _x("user_annotation", "batch#10", 4, 500.0, 100.0),    # no record
    ]
    if with_runtime:
        ev += [
            _x("cuda_runtime", "cudaLaunchKernel", 2, 200.0, 2.0,
               correlation=1),
            _x("cuda_runtime", "cudaMemcpyAsync", 2, 210.0, 2.0,
               correlation=2),
            _x("cuda_runtime", "cudaMemsetAsync", 2, 220.0, 2.0,
               correlation=3),
            _x("cuda_runtime", "cudaLaunchKernelExC", 2, 230.0, 2.0,
               correlation=4),
            _x("cuda_runtime", "cudaStreamSynchronize", 2, 240.0, 2.0,
               correlation=5),                          # not counted
            _x("cuda_runtime", "cudaLaunchKernel", 3, 240.0, 2.0,
               correlation=6),                          # batch 8's
            _x("cuda_runtime", "cudaLaunchKernel", 2, 500.0, 2.0,
               correlation=7),                          # after batch 7
        ]
    return ev


def test_only_batches_wholly_inside_count(tmp_path, records):
    got = _read(_ctx(tmp_path, _events()))
    assert got["fused_cpu_ms_per_batch"] == pytest.approx(3.0)
    # pack, step and adapt of batch 7: wall 1200 ns, CPU 500 ns.
    assert got["fused_offcpu_pct"] == pytest.approx(100.0 * 700 / 1200)
    assert got["launches_per_batch"] == pytest.approx(4.0)


def test_a_cpu_trace_has_no_launches(tmp_path, records):
    got = _read(_ctx(tmp_path, _events(with_runtime=False)))
    assert got["launches_per_batch"] is None
    assert got["fused_cpu_ms_per_batch"] == pytest.approx(3.0)


def test_no_batch_reads_none(tmp_path, records):
    ev = [e for e in _events() if e["name"] not in ("batch#7",)]
    assert _read(_ctx(tmp_path, ev)) == dict.fromkeys(NAMES)


def test_a_program_without_records_reads_none(tmp_path, monkeypatch):
    monkeypatch.delattr(tracing, "batches")
    assert _read(_ctx(tmp_path, _events())) == dict.fromkeys(NAMES)


def test_tiny_traced_run_reports_the_program_spans(tiny):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    c = tiny("ecoli_paf.ont_2_8kb")
    c.per_layer = c.per_layer + [m for m in spec["per_layer"]
                                 if m["name"] in NAMES]
    # Three batches run at once: a stretch of the tiny cell's 2 batch ends
    # holds no batch wholly; 6 hold some.
    c.traffic["trace_batches"] = 6
    r = cell.run_cell(c, 2 ** 31 + 21, 10.0, True,
                      devices=[torch.device("cpu")])
    assert r["correct"], r["check"]
    m = r["metrics"]
    assert m["fused_cpu_ms_per_batch"]["value"] > 0
    assert m["fused_cpu_ms_per_batch"]["unit"] == "ms"
    assert 0 <= m["fused_offcpu_pct"]["value"] < 100
    assert "launches_per_batch" not in m           # no card, no runtime
