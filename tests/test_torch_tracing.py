"""The port's profiler hooks (bioinfo1_tpu_torch/utils/tracing.py).

* A CLI run under ``device_trace`` writes a Chrome trace that names the
  CLI's stages (``index_build``, ``index_upload``, ``map``) and the
  mapper's host scopes, worker threads included; its PAF bytes equal those
  of the same run without a trace.
* A Mapper dealing its batches to ``[cpu] * 2`` under the trace: each
  batch, whichever entry runs it, names one fused step's scopes.
* ``host_split``'s inclusive and exclusive times on a hand-made trace.
* ``StageTimers`` totals and counts still accumulate under the scopes.
* The batch records: a mapping run on three worker threads leaves one
  record a ``map_batch`` call, inside its ``batch#<id>`` scope, on the
  trace's clock, with every scope's name and nesting as before; a span's
  CPU and self CPU; a failing batch closes its record; the records stay
  bounded; the index spans and timers; ``batch_kernels`` on a hand-made
  trace.
"""

import collections
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from bioinfo1_tpu_torch import cli as tcli
from bioinfo1_tpu_torch.io import fastx
from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
from bioinfo1_tpu_torch.utils import tracing
from test_torch_cli import _cpu, _run, inputs  # noqa: F401

CPU = torch.device("cpu")


def test_cli_trace_names_stages_and_host_scopes(inputs, tmp_path):
    _, ref, fq, _ = inputs
    rc, plain, _ = _run(tcli.main, [ref, fq])
    assert rc == 0
    with tracing.device_trace(str(tmp_path), CPU):
        rc, traced, err = _run(tcli.main, [ref, fq, "--profile"])
    assert rc == 0, err
    assert traced == plain and traced.count("\n") > 20
    split = tracing.host_split(str(tmp_path / tracing.TRACE_FILE))
    for name in ("index_build", "index_upload", "index.build",
                 "index.upload", "map", "map_batch", "fused",
                 "fused.pack", "fused.upload", "fused.step", "fused.fetch",
                 "fused.adapt", "step.minimize", "step.lookup", "step.chain",
                 "step.regions", "step.align", "realign", "band_pass",
                 "format", "iter.wait"):
        assert name in split, name
    # The batches run on worker threads, the stages on the caller's.
    assert split["map"]["threads"] == 1
    assert split["map_batch"]["threads"] >= 1
    assert split["map_batch"]["calls"] == split["format"]["calls"]
    for row in split.values():
        assert 0 <= row["excl_s"] <= row["incl_s"] + 1e-9
    assert split["map"]["excl_s"] < split["map"]["incl_s"]


def test_split_mapper_trace_names_shards(inputs, tmp_path):
    _, ref, fq, _ = inputs
    recs = list(fastx.parse_reads(fq).records)
    mapper = Mapper(fastx.parse_fasta_any(ref), MapperConfig(batch_size=8),
                    devices=[CPU, CPU])
    with tracing.device_trace(str(tmp_path), CPU):
        lines = mapper.map_records(recs)
    assert len(lines) >= len(recs) - 2
    split = tracing.host_split(str(tmp_path / tracing.TRACE_FILE))
    assert split["map_batch"]["calls"] == sum(mapper.devices.batches)
    assert min(mapper.devices.batches) >= 1
    n = split["fused"]["calls"]
    assert n >= split["map_batch"]["calls"]
    for name in ("fused.upload", "fused.step", "fused.fetch"):
        assert split[name]["calls"] == n, name


def test_host_split_nesting(tmp_path):
    def span(name, ts, dur, tid):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur, "tid": tid, "pid": 1}
    events = [span("a", 0, 100, 1), span("b", 10, 30, 1),
              span("c", 15, 5, 1), span("b", 50, 20, 1),
              span("a", 0, 40, 2), span("b", 40, 10, 2),
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 20,
               "dur": 50, "tid": 1, "pid": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = tracing.host_split(str(path))
    # calls, threads, inclusive and exclusive microseconds
    want = {"a": (2, 2, 140, 100 - 30 - 20 + 40), "b": (3, 2, 60, 55),
            "c": (1, 1, 5, 5)}
    assert set(got) == set(want)
    for name, (calls, threads, incl, excl) in want.items():
        row = got[name]
        assert (row["calls"], row["threads"]) == (calls, threads), name
        assert row["incl_s"] == pytest.approx(incl * 1e-6), name
        assert row["excl_s"] == pytest.approx(excl * 1e-6), name


def test_stage_timers_accumulate_under_scopes(tmp_path):
    timers = tracing.StageTimers(CPU)
    with tracing.device_trace(str(tmp_path), CPU):
        for _ in range(2):
            with timers.stage("work"):
                time.sleep(0.01)
        with timers.stage("other"):
            pass
    assert timers.counts == {"work": 2, "other": 1}
    assert timers.totals["work"] >= 0.02
    assert set(timers.as_dict()) == {"work", "other"}
    assert "work" in timers.report()
    split = tracing.host_split(os.path.join(tmp_path, tracing.TRACE_FILE))
    assert split["work"]["calls"] == 2 and split["other"]["calls"] == 1


def _scopes(trace_path):
    """(base ns, [(tid, ts us, end us, name, parent name or None)]): each
    scope of a Chrome trace with the innermost scope holding it on its
    thread; ``batch#<id>`` names kept whole."""
    with open(trace_path) as fh:
        doc = json.load(fh)
    by_tid: dict = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            by_tid.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]))
    out = []
    for tid, spans in by_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        for ts, end, name in spans:
            while stack and stack[-1][1] <= ts:
                stack.pop()
            out.append((tid, ts, end, name, stack[-1][2] if stack else None))
            stack.append((ts, end, name))
    return doc["baseTimeNanoseconds"], out


# Each scope of a score-only mapping run and the scope that holds it: the
# batch's record adds batch#<id> around map_batch, and nothing else moves.
NESTING = {
    "batch#": None, "map_batch": "batch#", "fused": "map_batch",
    "fused.pack": "fused", "fused.upload": "fused", "fused.step": "fused",
    "fused.fetch": "fused", "fused.adapt": "fused",
    "step.minimize": "fused.step", "step.lookup": "fused.step",
    "step.chain": "fused.step", "step.regions": "fused.step",
    "step.align": "fused.step", "realign": "map_batch",
    "band_pass": "realign", "host_path": "map_batch", "decode": "band_pass",
    "iter.wait": None, "format": None, "index.upload": None,
}


def _norm(name):
    return tracing.BATCH_PREFIX if name and name.startswith(
        tracing.BATCH_PREFIX) else name


def test_every_batch_leaves_one_record_inside_its_scope(inputs, tmp_path):
    _, ref, fq, _ = inputs
    recs = list(fastx.parse_reads(fq).records)
    mapper = Mapper(fastx.parse_fasta_any(ref), MapperConfig(batch_size=8),
                    device=CPU)
    known = {r.id for r in tracing.batches}
    with tracing.device_trace(str(tmp_path), CPU):
        lines = mapper.map_records(recs)
    assert len(lines) >= len(recs) - 2
    assert tracing.current() is None
    mine = [r for r in tracing.batches if r.id not in known]
    base, scopes = _scopes(str(tmp_path / tracing.TRACE_FILE))
    batch_scopes = {s[3]: s for s in scopes
                    if s[3].startswith(tracing.BATCH_PREFIX)}
    map_batch = [s for s in scopes if s[3] == "map_batch"]
    # One record a map_batch call, ids unique, each in its own scope.
    assert len(mine) == len(map_batch) == len(batch_scopes) >= 3
    assert len({r.id for r in mine}) == len(mine)
    assert len({r.thread for r in mine}) > 1          # the batch threads
    starts = []
    for r in mine:
        tid, ts, end, _name, parent = batch_scopes[
            f"{tracing.BATCH_PREFIX}{r.id}"]
        assert parent is None and tid == r.thread
        inner = [s for s in map_batch if s[0] == tid and ts <= s[1]
                 and s[2] <= end]
        assert len(inner) == 1 and inner[0][4] == batch_scopes[
            f"{tracing.BATCH_PREFIX}{r.id}"][3]
        # The trace's clock: the record's end within 1 ms of its scope's,
        # its start inside the scope.  The start is read once the scope's
        # enter returns, which may first wait for the interpreter lock (or,
        # at a thread's first scope, for the profiler to take the thread
        # on): the typical start is within 1 ms, below.
        t0, t1 = ts * 1000 + base, end * 1000 + base
        assert t0 - 1e6 < r.t0_ns < t1 and abs(r.t1_ns - t1) < 1e6
        starts.append(abs(r.t0_ns - t0))
        assert 0 < r.cpu_ns <= r.t1_ns - r.t0_ns
        assert r.reads > 0 and r.device is None and r.raised is None
        assert r.faults == 0 and not r.launches         # no card, no kernel
        assert r.fused_calls == r.spans["fused"].calls >= 1
        assert r.realign_passes == r.spans.get(
            "realign", tracing.SpanTotals()).calls
        for name, row in r.spans.items():
            assert 0 <= row.self_cpu_ns <= row.cpu_ns <= row.wall_ns, name
        in_batch = [s for s in scopes if s[0] == tid and ts < s[1]
                    and s[2] <= end and s[3] != "map_batch"]
        for name, row in r.spans.items():
            if name != "map_batch":
                assert row.calls == sum(1 for s in in_batch
                                        if s[3] == name), name
    assert sorted(starts)[len(starts) // 2] < 1e6
    assert sum(r.reads for r in mine) == len(recs)
    # Each realign pass takes at least one rerouted read.
    assert mapper.counters.realign_reroutes >= sum(
        r.realign_passes for r in mine) > 0
    assert mapper.counters.batches == sum(
        r.fused_calls + r.realign_passes + r.host_chunks for r in mine)
    # Names and nesting as before the records, batch#<id> aside.
    nesting = {}
    for _tid, _ts, _end, name, parent in scopes:
        nesting.setdefault(_norm(name), set()).add(_norm(parent))
    assert {"fused.adapt", "step.align", "realign", "iter.wait"} <= set(
        nesting)
    for name, parents in nesting.items():
        assert parents == {NESTING[name]}, (name, parents)


def test_a_failing_batch_closes_its_record(inputs, monkeypatch):
    _, ref, fq, _ = inputs
    seqs = [s for _, s in fastx.parse_reads(fq).records][:6]
    mapper = Mapper(fastx.parse_fasta_any(ref), MapperConfig(), device=CPU)

    def fail(*_a, **_k):
        raise RuntimeError("injected")

    # Isolated inside the call: counted, the reads go to the host path.
    monkeypatch.setattr(mapper, "_map_bucket_fused", fail)
    with ThreadPoolExecutor(1) as pool:
        pool.submit(mapper.map_batch, seqs).result()
    rec = tracing.batches[-1]
    assert rec.faults == mapper.counters.faults >= 1
    assert rec.host_chunks >= 1 and rec.raised is None and rec.t1_ns > 0
    # Raised out of the call: the record still closes and names it.
    monkeypatch.setattr(mapper, "_map_batch", fail)
    with ThreadPoolExecutor(1) as pool:
        with pytest.raises(RuntimeError, match="injected"):
            pool.submit(mapper.map_batch, seqs).result()
    rec = tracing.batches[-1]
    assert rec.raised == "RuntimeError" and rec.t1_ns >= rec.t0_ns > 0
    assert rec.cpu_ns > 0 and tracing.current() is None


def test_records_stay_bounded(inputs, monkeypatch):
    _, ref, fq, _ = inputs
    seqs = [s for _, s in fastx.parse_reads(fq).records][:4]
    assert tracing.batches.maxlen == tracing.BATCH_RECORDS
    monkeypatch.setattr(tracing, "batches", collections.deque(maxlen=2))
    mapper = Mapper(fastx.parse_fasta_any(ref), MapperConfig(), device=CPU)
    with ThreadPoolExecutor(1) as pool:
        ids = [pool.submit(lambda: (mapper.map_batch(seqs),
                                    tracing.batches[-1].id)[1]).result()
               for _ in range(4)]
    assert [r.id for r in tracing.batches] == ids[-2:]
    assert ids == sorted(set(ids))


def test_spans_count_cpu_and_self_cpu_on_their_thread():
    def burn(seconds):
        t = time.thread_time()
        while time.thread_time() - t < seconds:
            pass

    def one_batch():
        with tracing.batch(3) as rec:
            with tracing.span("outer"):
                burn(0.02)
                with tracing.span("inner"):
                    burn(0.03)
                time.sleep(0.05)
            with tracing.span("inner"):
                pass
        return rec

    with ThreadPoolExecutor(1) as pool:
        rec = pool.submit(one_batch).result()
    outer, inner = rec.spans["outer"], rec.spans["inner"]
    assert (outer.calls, inner.calls, rec.reads) == (1, 2, 3)
    assert inner.cpu_ns >= 0.03e9 and outer.cpu_ns >= 0.05e9
    # The first inner span is nested in outer, the second is not.
    assert 0.02e9 <= outer.self_cpu_ns <= outer.cpu_ns - 0.03e9
    assert outer.wall_ns >= outer.cpu_ns + 0.04e9     # the sleep is off CPU
    assert rec.cpu_ns >= outer.cpu_ns and rec.t1_ns - rec.t0_ns >= 0.1e9
    # Outside a batch a span is a scope alone.
    with tracing.span("free"):
        pass
    assert tracing.current() is None


def test_index_spans_and_timers(inputs, tmp_path):
    _, ref, _, _ = inputs
    with tracing.device_trace(str(tmp_path), CPU):
        mapper = Mapper(fastx.parse_fasta_any(ref), MapperConfig(),
                        device=CPU)
        mapper.device_index()
        mapper.device_index()
    split = tracing.host_split(str(tmp_path / tracing.TRACE_FILE))
    assert split["index.build"]["calls"] == 1
    assert split["index.upload"]["calls"] == 1        # the first call only
    c = mapper.counters.as_dict()
    assert c["t_index_build_s"] > 0 and c["t_index_upload_s"] > 0
    assert "dp_cells" not in c


def test_batch_kernels_ties_port_kernels_to_their_batch(tmp_path):
    def x(cat, name, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
                "ts": ts, "dur": dur, "args": args}

    reg = "void (anonymous namespace)::band_reg_kernel<{}>(BandArgs)"
    events = [
        x("user_annotation", "batch#3", 5, 100.0, 100.0),
        x("user_annotation", "batch#4", 6, 100.0, 200.0),
        x("user_annotation", "batch#9", 7, 100.0, 50.0),       # no kernel
        x("cuda_runtime", "cudaLaunchKernel", 5, 150.0, 2.0, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 6, 250.0, 2.0, correlation=2),
        x("cuda_driver", "cuLaunchKernelEx", 6, 260.0, 2.0, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 5, 250.0, 2.0, correlation=4),
        x("cuda_runtime", "cudaLaunchKernel", 6, 270.0, 2.0, correlation=5),
        x("kernel", reg.format("false, true, 0, 8, false, false"), 9, 300.0,
          5.0, correlation=1),
        x("kernel", "void (anonymous namespace)::lis_chain_kernel<1>(int "
          "const*, int)", 9, 310.0, 5.0, correlation=2),
        x("kernel", reg.format("true, true, 0, 8, true, true"), 9, 320.0,
          5.0, correlation=3),
        x("kernel", "void full_score_kernel<0, 16>(FullArgs)", 9, 330.0,
          5.0, correlation=4),                      # outside every batch
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
          9, 340.0, 5.0, correlation=5),            # not the port's
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert tracing.batch_kernels(str(path)) == {
        3: {("bioinfo1_band_score", "warp"): 1},
        4: {("bioinfo1_lis_chain", "state"): 1,
            ("bioinfo1_band_parents", "cluster"): 1},
        9: {}}
    for name, want in [
            (reg.format("true, false, 2, 8, true, false"),
             ("bioinfo1_band_parents", "warps")),
            ("void band_strip_kernel<false, true, 1>(BandArgs, StripArgs)",
             ("bioinfo1_band_score", "strip")),
            ("void band_scratch_kernel<true>(unsigned char const*)",
             ("bioinfo1_band_parents", "scratch")),
            ("void band_epoch_kernel<true, 0, 64>(BandArgs, EpochArgs)",
             ("bioinfo1_band_score", "epochs")),
            ("void band_epoch_merge_kernel<2>(BandArgs, EpochArgs)",
             ("bioinfo1_band_score", "epochs")),
            ("void walk_parents_kernel<false>(unsigned char const*)",
             ("bioinfo1_walk_parents", "")),
            ("void lis_chain_kernel<3>(int const*)",
             ("bioinfo1_lis_chain", "wide")),
            ("Memcpy HtoD (Pageable -> Device)", None)]:
        assert tracing.kernel_entry(name) == want, name
