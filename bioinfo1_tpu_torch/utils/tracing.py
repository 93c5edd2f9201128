"""Stage timers, throughput counters and profiler hooks (port of
bioinfo1_tpu/utils/tracing.py).

* ``StageTimers.stage(name)``: wall-clock stage timers that aggregate into
  a report, doubling as ``torch.profiler.record_function`` scopes (and NVTX
  ranges on a CUDA device), so a trace shows the same stage names.  The
  stage synchronises the CUDA device before it reads the clock, so its wall
  time includes the device work it queued (PyTorch returns before the card
  finishes).
* ``device_trace(log_dir, device)``: capture a ``torch.profiler`` trace of
  every thread (host ops, the mapper's scopes and, on CUDA, the kernels and
  copies) and write it to ``log_dir/trace.json`` (Chrome trace format: open
  it in Perfetto or chrome://tracing); ``host_split`` reads the scopes back.
* ``Counters``: throughput counters (reads, bases, DP cells) with derived
  reads/s and GCUPS.

``--profile`` prints the stage report, the ``Counters`` line and the
mapper's own counters (pipeline/mapper.py ``MapperCounters``).  The mapper's
host steps carry ``record_function`` scopes of their own (``map_batch``,
``fused.*``, ``realign``, ``host_path``, ``decode``, ``format``, ...): with
no profiler active each costs a few microseconds, a handful per batch.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


class StageTimers:
    """Named wall-clock accumulators with profiler annotations."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        with torch.profiler.record_function(name), \
                (torch.cuda.nvtx.range(name) if cuda
                 else contextlib.nullcontext()):
            yield
            if cuda:
                torch.cuda.synchronize(self.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                          total_s   calls    avg_ms"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<30} {t:8.3f} {c:7d} {1e3 * t / c:9.3f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


class Counters:
    """Throughput counters with derived rates."""

    def __init__(self) -> None:
        self.reads = 0
        self.bases = 0
        self.dp_cells = 0.0
        self.mapped = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def observe(self, n_reads: int, n_bases: int, dp_cells: float,
                n_mapped: int) -> None:
        self.reads += n_reads
        self.bases += n_bases
        self.dp_cells += dp_cells
        self.mapped += n_mapped

    def summary(self) -> Dict[str, float]:
        dt = (time.perf_counter() - self._t0) if self._t0 else 0.0
        out = {"reads": self.reads, "bases": self.bases,
               "mapped": self.mapped, "wall_s": round(dt, 3)}
        if dt > 0:
            out["reads_per_s"] = round(self.reads / dt, 2)
            out["gcups"] = round(self.dp_cells / dt / 1e9, 4)
        return out

    def json_line(self) -> str:
        return json.dumps(self.summary())


def scoped(name: str):
    """Decorator: each call runs inside a ``record_function(name)`` scope of
    its own (one ``record_function`` object used as the decorator would be
    shared by the threads that call the function at once)."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return deco


@contextlib.contextmanager
def device_trace(log_dir: str,
                 device: torch.device) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed code on every thread (the mapper maps its
    batches on worker threads), with CUDA activity when ``device`` is a
    CUDA device; on exit write the Chrome trace to ``log_dir/trace.json``.
    Yields the profiler, whose ``events()`` are readable after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def host_split(trace_path: str) -> Dict[str, dict]:
    """Per scope name of a Chrome trace written by ``device_trace``: calls,
    threads, inclusive seconds and exclusive seconds (less the scopes
    nested in it on the same thread), summed over threads.  A scope is a
    ``record_function`` range (trace category ``user_annotation``)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    by_tid: dict = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            by_tid[e["tid"]].append((float(e["ts"]), float(e["dur"]),
                                     e["name"]))
    out: Dict[str, dict] = {}
    for tid, spans in by_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []        # [end, name, nested_us, dur_us]
        closed: list = []

        def pop():
            end, name, nested, dur = stack.pop()
            closed.append((name, dur, dur - nested))
            if stack:
                stack[-1][2] += dur

        for ts, dur, name in spans:
            while stack and stack[-1][0] <= ts:
                pop()
            stack.append([ts + dur, name, 0.0, dur])
        while stack:
            pop()
        for name, dur, excl in closed:
            row = out.setdefault(name, {"calls": 0, "threads": set(),
                                        "incl_s": 0.0, "excl_s": 0.0})
            row["calls"] += 1
            row["threads"].add(tid)
            row["incl_s"] += dur / 1e6
            row["excl_s"] += excl / 1e6
    for row in out.values():
        row["threads"] = len(row["threads"])
    return out
