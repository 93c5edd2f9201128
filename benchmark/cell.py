"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the traced stretch, the check against the plain reference, the result.

Everything a cell is made of is found by name: the configuration's file
(``configs`` in ``BENCHMARK.json``), its genome's generator
(``benchmark/genomes/<generator>.py``), the traffic mix
(``benchmark/traffic/<traffic>.json``), the configuration's reference
(``benchmark/references/<reference>.py``) and each metric's reader
(``benchmark/metrics/<name>.py``, a ``read(ctx)`` that returns a number or
None): end-to-end metrics read the window's ``Context``, per-layer ones the
traced run's.

Set-up makes the genome and the read pool from the seed, builds the
``Mapper`` (which builds the index on the host), uploads the index, and maps
the pool until the mapper's adaptive bands and budget boosts stop moving.
The window is a closed loop: ``Mapper.map_records_iter`` is fed a stream
that cycles over the pool, and the reads whose lines it yielded by the
deadline count.  With ``trace`` a stretch of the window holding
``trace_batches`` batches runs under ``torch.profiler``; the kernel
wrappers and the scope around each of their calls are installed for that
stretch only.
"""

from __future__ import annotations

import gc
import importlib.util
import inspect
import itertools
import json
import os
import sys
import tempfile
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from benchmark import simulate, tracefile, work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bioinfo1_tpu")


class CellError(RuntimeError):
    """A run that cannot report: no card, a forbidden module, a bad cell."""


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that no run may load, compared
    whole (``bioinfo1_tpu_torch`` is not ``bioinfo1_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise CellError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` resolved to its files."""

    def __init__(self, workload: str, spec_path: Optional[str] = None,
                 traffic_dir: Optional[str] = None) -> None:
        spec_path = spec_path or os.path.join(ROOT, "BENCHMARK.json")
        root = os.path.dirname(os.path.abspath(spec_path))
        with open(spec_path) as fh:
            spec = json.load(fh)
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise CellError(f"no workload {workload!r} in {spec_path}")
        self.name = workload
        self.entry = cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as fh:
            self.config = json.load(fh)
        tdir = traffic_dir or os.path.join(HERE, "traffic")
        with open(os.path.join(tdir, self.entry["traffic"] + ".json")) as fh:
            self.traffic = json.load(fh)

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        self.chips = int(self.entry["chips"])

    def reference(self):
        return load_module(os.path.join(HERE, "references",
                                        self.config["reference"] + ".py"),
                           "bm_reference_" + self.config["reference"])

    def reader(self, metric: str):
        return load_module(os.path.join(HERE, "metrics", metric + ".py"),
                           "bm_metric_" + metric.replace(".", "_"))

    def mapper_kwargs(self) -> dict:
        kw = dict(self.config["mapper"])
        if self.traffic.get("batch_size"):
            kw["batch_size"] = int(self.traffic["batch_size"])
        return kw


class Stream(Sequence):
    """The window's input: the pool, cycled; read i is pool read i mod P,
    named ``r<pool index>.<cycle>``.  ``fed`` is how far the mapper had read
    by ``deadline``."""

    def __init__(self, pool: List[str], cycles: int = 10 ** 6) -> None:
        self.pool = pool
        self.n = len(pool) * cycles
        self.fed = 0
        self.deadline = float("inf")

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            raise TypeError("Stream: no slices")
        if time.perf_counter() <= self.deadline:
            self.fed = max(self.fed, i + 1)
        c, p = divmod(i, len(self.pool))
        return f"r{p}.{c}", self.pool[p]


class FaultLedger:
    """``Mapper.counters`` seen through: counts, by thread, the faults the
    mapper's isolation records, so that each batch knows its own."""

    def __init__(self, inner) -> None:
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "by_thread", defaultdict(int))

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def __setattr__(self, k, v):
        if k == "faults":
            self.by_thread[threading.get_ident()] += v - self._inner.faults
        setattr(self._inner, k, v)


class KernelCalls:
    """For the traced stretch: the port's K1 and K2 / K4 entry points
    wrapped, each call inside a ``bm.call#<id>`` scope, its arguments'
    shapes and lengths kept (on the device, copied) for the work count
    after the run.  The program's result is returned untouched."""

    def __init__(self) -> None:
        from bioinfo1_tpu_torch.ops import band, chain
        self.targets = [(chain, "lis_chain", self._chain),
                        (band, "align_scores_banded", self._band)]
        self.real = {}
        self.calls: List[tuple] = []
        self.ids = itertools.count()
        self.lock = threading.Lock()

    def _scoped(self, fn, keep):
        import torch
        sig = inspect.signature(fn)
        calls = self

        class Scoped:
            """``fn`` with each call in its scope; the program's counters
            on ``fn`` (``launches``, ``path_launches``) stay ``fn``'s."""

            def __call__(self, *args, **kwargs):
                with calls.lock:
                    cid = next(calls.ids)
                with torch.profiler.record_function(
                        f"{tracefile.CALL_PREFIX}{cid}"):
                    out = fn(*args, **kwargs)
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                rec = keep(bound.arguments)
                with calls.lock:
                    calls.calls.append((cid,) + rec)
                return out

            def __getattr__(self, k):
                return getattr(fn, k)

            def __setattr__(self, k, v):
                setattr(fn, k, v)

        return Scoped()

    @staticmethod
    def _chain(a):
        return ("K1", a["f_pos"].clone(), a["count"].clone())

    @staticmethod
    def _band(a):
        return ("K4" if a["want_parents"] else "K2", a["q_bytes"].shape[1],
                a["t_bytes"].shape[1], a["q_lens"].clone(),
                a["t_lens"].clone(), int(a["band"]))

    def install(self) -> None:
        for mod, name, keep in self.targets:
            self.real[name] = getattr(mod, name)
            setattr(mod, name, self._scoped(self.real[name], keep))

    def remove(self) -> None:
        for mod, name, _ in self.targets:
            if name in self.real:
                setattr(mod, name, self.real.pop(name))

    def bounds(self) -> Dict[int, tuple]:
        """{call id: (kind, the card's least seconds for it)}."""
        out = {}
        for rec in self.calls:
            cid, kind = rec[0], rec[1]
            if kind == "K1":
                w = work.chain_work(rec[2].cpu().numpy(), rec[3].cpu().numpy())
            else:
                n, m, ql, tl, band = rec[2:]
                w = work.band_work(n, m, ql.cpu().numpy(), tl.cpu().numpy(),
                                   band, kind == "K4")
            out[cid] = (kind, work.bound_s(w))
        self.calls.clear()
        return out


class Stretch(threading.Thread):
    """The traced stretch, driven from a thread of its own so that it does
    not wait on the window's yields: ``torch.profiler`` warms up once
    ``LEAD`` batches have finished, records from the next batch's end for
    ``n`` more (the kernel wrappers installed, the ``bm.stretch`` scope
    open on this thread), and stops at the deadline at the latest (set
    before ``start``).  ``marks`` gets "B" and "C", the counters at its
    start and end."""

    LEAD = 2

    def __init__(self, on_card: bool, batches: list, marks: dict, snap,
                 n: int) -> None:
        super().__init__(name="bm-stretch", daemon=True)
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=1, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=lambda p: None,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True))
        if on_card:
            # The first profiler session of a process initialises CUPTI,
            # which takes seconds and holds up every thread's CUDA calls:
            # pay it here, in set-up, and not in the window.
            with torch.profiler.profile(activities=acts):
                torch.cuda.synchronize()
        self.prof.start()
        self.calls = KernelCalls()
        self.batches, self.marks, self.snap = batches, marks, snap
        self.deadline, self.n = float("inf"), n
        self.done = threading.Event()
        self.recorded = False
        self.error: Optional[BaseException] = None

    def _until(self, count: int) -> None:
        while (len(self.batches) < count and not self.done.is_set()
               and time.perf_counter() < self.deadline):
            self.done.wait(0.005)

    def run(self) -> None:
        import torch
        try:
            self._until(self.LEAD)
            self.prof.step()                         # warm-up
            self._until(self.LEAD + 1)
            if self.done.is_set() or time.perf_counter() >= self.deadline:
                return
            self.prof.step()                         # recording
            self.calls.install()
            with torch.profiler.record_function(tracefile.STRETCH):
                self.marks["B"] = self.snap()
                self._until(len(self.batches) + self.n)
                self.calls.remove()
                self.marks["C"] = self.snap()
            self.prof.step()                         # recorded
            self.recorded = True
        except BaseException as e:                   # noqa: BLE001
            self.error = e
        finally:
            self.calls.remove()

    def finish(self) -> None:
        self.done.set()
        self.join()
        self.prof.stop()
        if self.error is not None:
            raise self.error


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             devices=None, t_start: Optional[float] = None,
             break_path: Optional[Callable] = None) -> dict:
    """One run; returns the result object.  ``devices`` (a list of torch
    devices) replaces the card check and the configuration's device
    choice: the CPU tests pass ``[cpu]``.  ``break_path(mapper)`` breaks the
    timed path before the window (the fault tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    os.environ["BIOINFO1_BAND_CACHE"] = "0"
    import torch
    from bioinfo1_tpu_torch.index import builder
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig

    on_card = devices is None
    if on_card:
        if not torch.cuda.is_available():
            raise CellError("no CUDA device: this benchmark runs on the card")
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f"{cell.name} needs {cell.chips} cards, "
                            f"{torch.cuda.device_count()} visible")

    gcfg = cell.config["genome"]
    genome = simulate.make_genome(gcfg, seed)
    pool_info = simulate.make_pool(genome, cell.traffic,
                                   simulate.rng_for(seed, 1))
    pool = [s for _, s in pool_info]
    genome_str = genome.tobytes().decode("latin1")
    setup: Dict[str, float] = {}

    real_build = builder.build_index

    def timed_build(*a, **k):
        t = time.perf_counter()
        try:
            return real_build(*a, **k)
        finally:
            setup["index_build_s"] = time.perf_counter() - t

    cfg = MapperConfig(**cell.mapper_kwargs())
    builder.build_index = timed_build
    try:
        if on_card:
            mapper = Mapper([(gcfg["name"], genome_str)], cfg,
                            device=torch.device("cuda", 0))
        else:
            mapper = Mapper([(gcfg["name"], genome_str)], cfg,
                            devices=devices)
    finally:
        builder.build_index = real_build
    used = mapper.devices.distinct()
    if on_card and len(mapper.devices.devices) != cell.chips:
        raise CellError(f"{cell.name}: the mapper took "
                        f"{len(mapper.devices.devices)} cards, the cell "
                        f"states {cell.chips}")

    def sync():
        for d in used:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    t = time.perf_counter()
    mapper.device_index()
    sync()
    setup["index_upload_s"] = time.perf_counter() - t

    warm = [(f"w{i}", s) for i, s in enumerate(pool)]
    for _ in range(int(cell.traffic.get("warm_passes", 5))):
        before = (dict(mapper._band_by_key), dict(mapper._budget_boost))
        mapper.map_records(warm)
        if (dict(mapper._band_by_key), dict(mapper._budget_boost)) == before:
            break
    sync()
    setup_peak = {d: torch.cuda.max_memory_allocated(d) for d in used
                  if d.type == "cuda"}
    for d in used:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)

    ledger = FaultLedger(mapper.counters)
    mapper.counters = ledger
    batches: List[tuple] = []          # (t0, t1, reads, faults)
    real_map_batch = mapper.map_batch

    def timed_map_batch(seqs):
        tid = threading.get_ident()
        f0 = ledger.by_thread[tid]
        t0 = time.perf_counter()
        try:
            return real_map_batch(seqs)
        finally:
            batches.append((t0, time.perf_counter(), len(seqs),
                            ledger.by_thread[tid] - f0))

    mapper.map_batch = timed_map_batch
    if break_path is not None:
        break_path(mapper)

    def snap():
        c = ledger._inner
        return {"t": time.perf_counter(), "reads": c.reads,
                "t_fused_s": c.t_fused_s,
                "realign_reroutes": c.realign_reroutes}

    stream = Stream(pool)
    P = len(pool)
    keep = set(sample(cell, seed, pool, P))
    lines: List[str] = []
    done = 0
    marks: dict = {}
    trace_dir = tempfile.mkdtemp(prefix="bm_trace_") if trace else None
    stretch = (Stretch(on_card, batches, marks, snap,
                       int(cell.traffic.get("trace_batches", 20)))
               if trace else None)
    setup_s = time.perf_counter() - t_start
    marks["A"] = snap()
    deadline = marks["A"]["t"] + seconds
    stream.deadline = deadline
    if stretch is not None:
        stretch.deadline = deadline
        stretch.start()
    it = mapper.map_records_iter(stream)
    try:
        for emitted, got in it:
            if time.perf_counter() > deadline:
                break
            done = emitted
            # Past the first cycle only the sample's lines are kept: the
            # window then has finished every pool read (see ``sample``).
            lines.extend(ln for ln in got if done <= P or int(
                ln[1:ln.index(".")]) in keep)
        else:
            raise CellError("the stream ended inside the window")
    finally:
        marks["D"] = snap()
        window_peak = {d: torch.cuda.max_memory_allocated(d) for d in used
                       if d.type == "cuda"}
        if stretch is not None:
            stretch.finish()
        it.close()                          # in-flight batches finish
        sync()
        mapper.map_batch = real_map_batch
        mapper.counters = ledger._inner
    found = forbidden_modules()
    if found:
        raise CellError("the run loaded " + ", ".join(found))

    result = {"correct": False, "attempted": stream.fed,
              "failed": int(sum(r for t0, t1, r, f in batches
                                if f and t0 < deadline)),
              "metrics": {}, "device": {}}
    window_done = done
    counts = {"reads_in_window": window_done,
              "batches_in_window": sum(1 for b in batches if b[1] <= deadline),
              "reads_of_batches_in_window": sum(b[2] for b in batches
                                                if b[1] <= deadline)}
    ctx = None
    if trace:
        path = os.path.join(trace_dir, "trace.json")
        if stretch.recorded:
            stretch.prof.export_chrome_trace(path)
        ctx = _trace_context(cell, path if stretch.recorded else None,
                             stretch.calls, marks, batches, setup, used)
        for fn in os.listdir(trace_dir):
            os.remove(os.path.join(trace_dir, fn))
        os.rmdir(trace_dir)

    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(0) if on_card
                       else "cpu"),
              "count": len(mapper.devices.devices),
              "memory_peak_bytes": int(max(
                  [max(setup_peak.get(d, 0), window_peak.get(d, 0))
                   for d in used] or [0]))}

    # The program's state goes before the reference runs.
    mapper = ledger = None
    it = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        if ctx.trace is not None:
            device["busy_s"] = ctx.busy_mean_s
            device["window_s"] = ctx.trace.seconds
            result["breakdown"] = {
                "device_ops": ctx.trace.device_ops(10),
                "idle_gaps": ctx.trace.idle_gaps(ctx.card_ids, 10)}
        counts.update(ctx.counts)
    else:
        ctx = Context()
        ctx.cell, ctx.seconds, ctx.setup_s = cell, seconds, setup_s
        ctx.reads_in_window = window_done
        ctx.window_peak_bytes = dict(window_peak)
        for m in cell.end_to_end:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
    result["device"] = device
    result["counts"] = counts

    ref_dev = (torch.device("cuda", 0) if on_card else devices[0])
    check = judge(cell, seed, genome, pool, lines, window_done, ref_dev)
    found = forbidden_modules()
    if found:
        raise CellError("the run loaded " + ", ".join(found))
    result["correct"] = check.pop("_correct")
    result["check"] = check
    return result


class Context:
    """What the metrics' readers read (see benchmark/metrics/)."""


def _trace_context(cell: Cell, path: Optional[str], calls: KernelCalls,
                   marks: dict, batches: List[tuple], setup: dict,
                   used) -> Context:
    ctx = Context()
    ctx.cell = cell
    ctx.setup = dict(setup)
    ctx.trace = (tracefile.Trace(path, threading.main_thread().native_id)
                 if path else None)
    ctx.card_ids = [d.index for d in used if d.type == "cuda"]
    ctx.calls = []
    ctx.busy_mean_s = None
    if ctx.trace is not None:
        kernel_s = ctx.trace.call_kernel_s()
        for cid, (kind, bound) in calls.bounds().items():
            if kernel_s.get(cid, 0.0) > 0:
                ctx.calls.append((kind, bound, kernel_s[cid]))
        busy = ctx.trace.busy_s()
        ctx.busy_by_card = {d: busy.get(d, 0.0) for d in ctx.card_ids}
        if ctx.card_ids:
            ctx.busy_mean_s = (sum(ctx.busy_by_card.values())
                               / len(ctx.card_ids))
    # Host-clock readings: the window outside the profiled stretch.
    a, d = marks["A"], marks["D"]
    spans = [(a, marks.get("B", d)), (marks.get("C", d), d)]
    ctx.outside_batches = [t1 - t0 for t0, t1, _r, _f in batches
                           if any(s["t"] <= t0 and t1 <= e["t"]
                                  for s, e in spans)]
    ctx.outside = {k: sum(e[k] - s[k] for s, e in spans)
                   for k in ("reads", "t_fused_s")}
    ctx.outside["batches"] = sum(
        1 for t0, t1, _r, _f in batches
        if any(s["t"] <= t1 <= e["t"] for s, e in spans))
    ctx.window = {k: d[k] - a[k] for k in ("reads", "realign_reroutes")}
    ctx.counts = {"batches_outside_stretch": len(ctx.outside_batches),
                  "kernel_calls_traced": len(ctx.calls)}
    return ctx


def sample(cell: Cell, seed: int, pool: List[str], done: int) -> List[int]:
    """The pool reads the check compares: the longest of those the window
    finished, then a draw from the seed, ``check_reads`` in all."""
    P = len(pool)
    seen = sorted({i % P for i in range(min(done, P))})
    if not seen:
        return []
    longest = max(seen, key=lambda p: len(pool[p]))
    rest = [p for p in seen if p != longest]
    n = min(int(cell.traffic["check_reads"]), len(seen)) - 1
    draw = simulate.rng_for(seed, 2).choice(len(rest), n, replace=False)
    return [longest] + [rest[i] for i in sorted(draw)]


def reference_rows(cell: Cell, genome: np.ndarray, pool: List[str],
                   pick: List[int], device, band: int = 0
                   ) -> Dict[int, Optional[str]]:
    """{pool index: the reference's PAF row without its name column, or
    None}; ``band`` runs the control instead."""
    cfg = cell.config
    m = cfg["mapper"]
    ref = cell.reference()
    rows = ref.paf_rows(
        ref.Reference(cfg["genome"]["name"], genome, m["k"], m["w"], m["f"]),
        {f"r{p}": np.frombuffer(pool[p].encode("latin1"), np.uint8)
         for p in pick}, m["match"], m["mismatch"], m["gap"],
        bool(m["output_cigar"]), device, float(cfg["check"]["block_cells"]),
        band)
    return {p: rows[f"r{p}"] for p in pick}


def compare(rows: Dict[int, Optional[str]], lines: List[str], done: int,
            P: int) -> dict:
    """The check's numbers: every line the window yielded for the sampled
    reads against the reference's row; a read the reference maps and the
    window did not, or the reverse, differs too."""
    got: Dict[str, str] = {}
    for ln in lines:
        name, row = ln.split("\t", 1)
        got[name] = row
    compared = differing = 0
    examples = []
    for i in range(done):
        p = i % P
        if p not in rows:
            continue
        name = f"r{p}.{i // P}"
        have = got.get(name)
        compared += 1
        if have != rows[p]:
            differing += 1
            if len(examples) < 3:
                examples.append((name, have, rows[p]))
    for name, have, want in examples:
        print(f"differs: {name}\n  program:   {str(have)[:300]}\n"
              f"  reference: {str(want)[:300]}", file=sys.stderr)
    check = {"differing_rows": {"value": differing, "limit": 0,
                                "holds": "at most"},
             "compared_rows": {"value": compared, "limit": 1,
                               "holds": "at least"},
             "sampled_reads": {"value": len(rows), "limit": 1,
                               "holds": "at least"}}
    check["_correct"] = differing == 0 and compared >= 1 and len(rows) >= 1
    return check


def judge(cell: Cell, seed: int, genome: np.ndarray, pool: List[str],
          lines: List[str], done: int, device) -> dict:
    """The run's check (see ``sample`` and ``compare``)."""
    pick = sample(cell, seed, pool, done)
    return compare(reference_rows(cell, genome, pool, pick, device), lines,
                   done, len(pool))


def print_check(check: dict) -> None:
    for k, v in check.items():
        print(f"check {k}: {v['value']} ({v['holds']} {v['limit']})",
              file=sys.stderr)


def main(argv: Optional[Sequence[str]] = None,
         t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except (CellError, ImportError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print_check(result["check"])
    print(json.dumps(result))
    return 0
