"""Stage timers, throughput counters, the mapper's spans and batch
records, and profiler hooks (port of bioinfo1_tpu/utils/tracing.py).

* ``StageTimers.stage(name)``: wall-clock stage timers that aggregate into
  a report, doubling as ``torch.profiler.record_function`` scopes (and NVTX
  ranges on a CUDA device), so a trace shows the same stage names.  The
  stage synchronises the CUDA device before it reads the clock, so its wall
  time includes the device work it queued (PyTorch returns before the card
  finishes).
* ``span(name)``: the mapper's one way to open a scope.  It is a
  ``record_function(name)`` scope and, on a thread that runs a batch, adds
  its calls, wall ns (``time.time_ns``), thread-CPU ns
  (``time.thread_time_ns``) and self CPU ns (less the spans nested in it on
  the thread) to that batch's record.  ``scoped(name)`` is its decorator.
* ``batch(reads)``: one ``Mapper.map_batch`` call's record
  (``BatchRecord``), current on its thread for the call, inside a
  ``batch#<id>`` scope; ids come from one counter a process.  The newest
  ``BATCH_RECORDS`` records stay in ``batches``, beyond the mapper's life.
  ``count`` and ``count_launch`` add to the current record; the kernel
  launcher (kernels/build.launch) counts each launch by (entry point,
  path).  Thread CPU leaves out work that torch hands to its intra-op pool.
* ``device_trace(log_dir, device)``: capture a ``torch.profiler`` trace of
  every thread (host ops, the mapper's scopes and, on CUDA, the kernels and
  copies) and write it to ``log_dir/trace.json`` (Chrome trace format: open
  it in Perfetto or chrome://tracing); ``host_split`` reads the scopes back,
  ``batch_kernels`` the port's kernels by the batch that launched them.
* ``Counters``: throughput counters (reads, bases, mapped) with derived
  reads/s.

``--profile`` prints the stage report, the ``Counters`` line and the
mapper's own counters (pipeline/mapper.py ``MapperCounters``).  The record
is always on: the program cannot tell that a profiler is recording
(``torch.autograd._profiler_enabled()`` reads False while one records).
With no profiler active, on the host of an H100 machine (PERF.md), an
empty ``record_function`` scope costs 8-10 us and a span inside a
batch 16-20 us, most of the difference its two ``time.thread_time_ns``
reads (a 2.5-3 us system call there, 0.5 us on a plain CPU host); a fused
call opens ~15 spans, ~0.15 ms a batch.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import re
import threading
import time
from collections import defaultdict
from typing import Deque, Dict, Iterator, Optional, Tuple

import torch

TRACE_FILE = "trace.json"
BATCH_PREFIX = "batch#"
BATCH_RECORDS = 4096


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
    """Throughput counters with a derived rate."""

    def __init__(self) -> None:
        self.reads = 0
        self.bases = 0
        self.mapped = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def observe(self, n_reads: int, n_bases: int, n_mapped: int) -> None:
        self.reads += n_reads
        self.bases += n_bases
        self.mapped += n_mapped

    def summary(self) -> Dict[str, float]:
        dt = (time.perf_counter() - self._t0) if self._t0 else 0.0
        out = {"reads": self.reads, "bases": self.bases,
               "mapped": self.mapped, "wall_s": round(dt, 3)}
        if dt > 0:
            out["reads_per_s"] = round(self.reads / dt, 2)
        return out

    def json_line(self) -> str:
        return json.dumps(self.summary())


@dataclasses.dataclass
class SpanTotals:
    """One span name's totals in a batch, on the batch's thread."""

    calls: int = 0
    wall_ns: int = 0
    cpu_ns: int = 0            # thread CPU, the nested spans' included
    self_cpu_ns: int = 0       # less the CPU of the spans nested in it


@dataclasses.dataclass
class BatchRecord:
    """One ``Mapper.map_batch`` call.  ``t0_ns`` / ``t1_ns`` are
    ``time.time_ns()`` just inside its ``batch#<id>`` scope: the trace's
    clock (a Chrome trace's ``ts`` x 1000 + ``baseTimeNanoseconds``).
    ``t1_ns`` is 0 while the call runs."""

    id: int
    thread: int                       # native thread id, as in a trace
    reads: int
    t0_ns: int
    device: Optional[int] = None      # CUDA index of the batch's card
    t1_ns: int = 0
    cpu_ns: int = 0                   # thread CPU of the whole call
    spans: Dict[str, SpanTotals] = dataclasses.field(default_factory=dict)
    # Kernel launches by (C entry point, path; "" for one-path kernels).
    launches: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)
    fused_calls: int = 0
    realign_passes: int = 0
    host_chunks: int = 0
    faults: int = 0                   # failures isolated inside the call
    raised: Optional[str] = None      # the exception the call raised


# The newest records, oldest first; appended when a batch starts.
batches: Deque[BatchRecord] = collections.deque(maxlen=BATCH_RECORDS)
_batch_ids = itertools.count()
_local = threading.local()


def current() -> Optional[BatchRecord]:
    """The record of the batch this thread runs, if any."""
    return getattr(_local, "batch", None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to field ``name`` of the current batch's record."""
    rec = getattr(_local, "batch", None)
    if rec is not None:
        setattr(rec, name, getattr(rec, name) + n)


def count_launch(entry: str, path: str = "") -> None:
    """One kernel launch of C entry point ``entry`` on ``path``, for the
    current batch's record."""
    rec = getattr(_local, "batch", None)
    if rec is not None:
        key = (entry, path)
        rec.launches[key] = rec.launches.get(key, 0) + 1


class span:
    """``record_function(name)``, and on a thread that runs a batch the
    scope's calls, wall, CPU and self CPU added to the batch's record
    (``SpanTotals``).  A new object for each scope: threads share none."""

    __slots__ = ("name", "_rf", "_frame")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "span":
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        rec = getattr(_local, "batch", None)
        if rec is None:
            self._frame = None
        else:
            # [record, wall0, cpu0, CPU of the spans nested in it]
            self._frame = [rec, time.time_ns(), time.thread_time_ns(), 0]
            _local.stack.append(self._frame)
        return self

    def __exit__(self, *exc) -> None:
        frame = self._frame
        if frame is not None:
            cpu = time.thread_time_ns() - frame[2]
            wall = time.time_ns() - frame[1]
            stack = _local.stack
            stack.pop()
            if stack:
                stack[-1][3] += cpu
            row = frame[0].spans.get(self.name)
            if row is None:
                row = frame[0].spans[self.name] = SpanTotals()
            row.calls += 1
            row.wall_ns += wall
            row.cpu_ns += cpu
            row.self_cpu_ns += cpu - frame[3]
        self._rf.__exit__(*exc)


def scoped(name: str):
    """Decorator: each call runs inside a ``span(name)`` of its own."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return deco


@contextlib.contextmanager
def batch(reads: int) -> Iterator[BatchRecord]:
    """One batch: the next id, its record appended to ``batches`` and
    current on this thread for the block, inside a ``batch#<id>`` scope.
    The record is closed (``t1_ns``, ``cpu_ns``) also when the block
    raises, and names the exception in ``raised``."""
    rec = BatchRecord(id=next(_batch_ids), thread=threading.get_native_id(),
                      reads=reads, t0_ns=0)
    outer = (getattr(_local, "batch", None), getattr(_local, "stack", None))
    with torch.profiler.record_function(f"{BATCH_PREFIX}{rec.id}"):
        rec.t0_ns, cpu0 = time.time_ns(), time.thread_time_ns()
        _local.batch, _local.stack = rec, []
        batches.append(rec)
        try:
            yield rec
        except BaseException as e:
            rec.raised = type(e).__name__
            raise
        finally:
            _local.batch, _local.stack = outer
            rec.cpu_ns = time.thread_time_ns() - cpu0
            rec.t1_ns = time.time_ns()


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


_KERNEL = re.compile(r"\b(\w+_kernel)(?:<([^>]*)>)?")
_ONE_PATH = {"full_score_kernel": "bioinfo1_full_score",
             "walk_parents_kernel": "bioinfo1_walk_parents",
             "int32_probe_kernel": "bioinfo1_int32_probe"}
_BAND_PATH = {"band_strip_kernel": "strip", "band_scratch_kernel": "scratch",
              "band_epoch_kernel": "epochs",
              "band_epoch_merge_kernel": "epochs"}


def kernel_entry(name: str) -> Optional[Tuple[str, str]]:
    """(C entry point, path) of one of the port's kernels (csrc/) from the
    name a trace gives it, e.g. ``void band_reg_kernel<false, true, 0, 8,
    false, false>(BandArgs)``; None for any other kernel.  The path is the
    one ``build.launch`` counts it under (ops/chain.CHAIN_PATHS,
    ops/band.PATHS)."""
    from bioinfo1_tpu_torch.ops.chain import CHAIN_PATHS
    m = _KERNEL.search(name)
    if m is None:
        return None
    fn, targs = m.group(1), [a.strip() for a in (m.group(2) or "").split(",")]
    if fn == "lis_chain_kernel":
        return "bioinfo1_lis_chain", CHAIN_PATHS[int(targs[0])]
    if fn in _ONE_PATH:
        return _ONE_PATH[fn], ""
    if fn == "band_reg_kernel":
        path = ("cluster" if targs[5] == "true" else
                "warps" if targs[4] == "true" else "warp")
    elif fn in _BAND_PATH:
        path = _BAND_PATH[fn]
    else:
        return None
    parents = path != "epochs" and targs[0] == "true"   # K2 only on epochs
    return ("bioinfo1_band_parents" if parents else "bioinfo1_band_score",
            path)


def batch_kernels(trace_path: str) -> Dict[int, Dict[Tuple[str, str], int]]:
    """{batch id: {(C entry point, path): kernels}} of a Chrome trace
    written by ``device_trace``: each of the port's kernels tied, by its
    correlation id, to the CUDA API call that launched it, and that call
    to the ``batch#<id>`` scope that holds it on the launching thread.  Every batch scope in the trace has an entry, empty if it
    launched none."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    scopes: dict = defaultdict(list)
    out: Dict[int, Dict[Tuple[str, str], int]] = {}
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e["name"].startswith(BATCH_PREFIX)):
            bid = int(e["name"][len(BATCH_PREFIX):])
            scopes[e["tid"]].append((float(e["ts"]),
                                     float(e["ts"]) + float(e["dur"]), bid))
            out[bid] = {}
    for v in scopes.values():
        v.sort()
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat", "").startswith("cuda_")
               and "correlation" in e.get("args", {})}
    for k in events:
        if k.get("cat") != "kernel":
            continue
        key = kernel_entry(k["name"])
        rt = runtime.get(k.get("args", {}).get("correlation"))
        if key is None or rt is None:
            continue
        spans = scopes.get(rt["tid"], [])
        ts = float(rt["ts"])
        i = bisect.bisect_right(spans, (ts, float("inf"), 0))
        if i and spans[i - 1][0] <= ts <= spans[i - 1][1]:
            row = out[spans[i - 1][2]]
            row[key] = row.get(key, 0) + 1
    return out
