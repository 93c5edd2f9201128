"""The port's profiler hooks (bioinfo1_tpu_torch/utils/tracing.py).

* A CLI run under ``device_trace`` writes a Chrome trace that names the
  CLI's stages (``index_build``, ``index_upload``, ``map``) and the
  mapper's host scopes, worker threads included; its PAF bytes equal those
  of the same run without a trace.
* A Mapper dealing its batches to ``[cpu] * 2`` under the trace: each
  batch, whichever entry runs it, names one fused step's scopes.
* ``host_split``'s inclusive and exclusive times on a hand-made trace.
* ``StageTimers`` totals and counts still accumulate under the scopes.
"""

import json
import os
import time

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
    for name in ("index_build", "index_upload", "map", "map_batch", "fused",
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
