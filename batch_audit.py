"""Run one benchmark cell traced, as ``benchmark/run.py --trace 1`` runs
it, keep its trace, and hold the port's batch records against it:

    python3 batch_audit.py --workload <cell> --seed <n> --seconds 30 \
        [--keep DIR]

For each batch whose ``batch#<id>`` scope lies wholly inside the traced
stretch, the kernel launches its record counts by (entry point, path)
(``bioinfo1_tpu_torch.utils.tracing``) against the port kernels the trace
ties to it (``tracing.batch_kernels``), each span's mean wall, CPU and
self CPU, and the runtime calls and operators that took most time inside
``fused.pack``, ``fused.step`` and ``fused.adapt``; for the whole
stretch, the CUDA runtime launch calls whose kernel the trace does not
hold (the profiler lost its record) and the card's longest idle gap.
Prints the run's result object (as ``benchmark/run.py`` does), then one
line ``{"audit": ...}``.
Needs a card, as the benchmark does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import defaultdict  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmark import cell, tracefile  # noqa: E402
from bioinfo1_tpu_torch.utils import tracing  # noqa: E402

OFFCPU_SPANS = ("fused.pack", "fused.step", "fused.adapt")


def audit(path: str) -> dict:
    """The records against the trace at ``path`` (see the module)."""
    trace = tracefile.Trace(path, 0)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    traced = tracing.batch_kernels(path)
    records = {r.id: r for r in tracing.batches}
    inside = [int(e["name"][len(tracing.BATCH_PREFIX):])
              for e in trace.scopes
              if e["name"].startswith(tracing.BATCH_PREFIX)
              and trace.t0 <= float(e["ts"])
              and float(e["ts"]) + float(e["dur"]) <= trace.t1]
    differ = {}
    for bid in inside:
        want = records[bid].launches if bid in records else None
        if want != traced.get(bid):
            differ[bid] = {"record": {"/".join(k): v for k, v in
                                      (want or {}).items()},
                           "trace": {"/".join(k): v for k, v in
                                     traced.get(bid, {}).items()}}
    kernel_corr = {e["args"].get("correlation") for e in events
                   if e.get("cat") == "kernel"}
    lost = [e for e in events if e.get("cat") == "cuda_runtime"
            and "Launch" in e["name"]
            and trace.t0 <= float(e["ts"]) <= trace.t1
            and e["args"].get("correlation") not in kernel_corr]
    # Per batch: each span's mean wall, CPU and self CPU (the records), and
    # the runtime calls and operators the batch threads made inside the
    # spans that ``fused_offcpu_pct`` reads, by the time they took.
    spans: dict = {}
    for bid in (b for b in inside if b in records):
        for name, row in records[bid].spans.items():
            acc = spans.setdefault(name, [0, 0, 0, 0])
            for i, v in enumerate((row.calls, row.wall_ns, row.cpu_ns,
                                   row.self_cpu_ns)):
                acc[i] += v
    n = max(len(inside), 1)
    span_means = {k: {"calls": v[0] / n, "wall_ms": v[1] / n / 1e6,
                      "cpu_ms": v[2] / n / 1e6, "self_cpu_ms": v[3] / n / 1e6}
                  for k, v in sorted(spans.items())}
    held = defaultdict(list)
    for e in trace.scopes:
        if e["name"] in OFFCPU_SPANS:
            held[e["tid"]].append((float(e["ts"]),
                                   float(e["ts"]) + float(e["dur"])))
    calls: dict = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cpu_op"):
            continue
        ts = float(e["ts"])
        if any(a <= ts <= b for a, b in held.get(e["tid"], ())):
            acc = calls[f'{e["cat"]}:{e["name"]}']
            acc[0] += 1
            acc[1] += float(e["dur"]) / 1e3 / n
    top = sorted(calls.items(), key=lambda kv: -kv[1][1])[:12]
    busy = trace.busy_by_device()
    gap = 0.0
    for merged in busy.values():
        edges = [trace.t0] + [x for s in merged for x in s] + [trace.t1]
        gap = max([gap] + [b - a for a, b in zip(edges[::2], edges[1::2])])
    return {
        "batches_inside": len(inside),
        "record_port_launches": sum(sum(records[b].launches.values())
                                    for b in inside if b in records),
        "traced_port_kernels": sum(sum(traced.get(b, {}).values())
                                   for b in inside),
        "port_kernels_in_stretch": sum(
            1 for e in trace.device if e.get("cat") == "kernel"
            and tracing.kernel_entry(e["name"]) is not None),
        "batches_differing": differ,
        "launches_without_kernel": len(lost),
        "launches_without_kernel_names": sorted({e["name"] for e in lost}),
        "busy_s": {d: sum(b - a for a, b in v) / 1e6
                   for d, v in busy.items()},
        "stretch_s": trace.seconds,
        "longest_idle_gap_s": gap / 1e6,
        "span_means": span_means,
        "in_offcpu_spans_ms_per_batch": {k: [c, round(ms, 3)]
                                         for k, (c, ms) in top},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--keep", help="copy the trace into this directory")
    args = ap.parse_args()
    kept = os.path.join(tempfile.mkdtemp(prefix="batch_audit_"),
                        "trace.json")
    real = cell._trace_context

    def keep_trace(c, path, *a, **k):
        if path:
            shutil.copy(path, kept)
        return real(c, path, *a, **k)

    cell._trace_context = keep_trace
    try:
        result = cell.run_cell(cell.Cell(args.workload), args.seed,
                               args.seconds, True, t_start=T_START)
    except (cell.CellError, ImportError) as e:
        print(f"batch_audit: {e}", file=sys.stderr)
        return 2
    cell.print_check(result["check"])
    print(json.dumps(result))
    if not os.path.exists(kept):
        print(json.dumps({"audit": None}))
        return 0
    out = audit(kept)
    if args.keep:
        os.makedirs(args.keep, exist_ok=True)
        shutil.copy(kept, os.path.join(
            args.keep, f"{args.workload}.{args.seed}.trace.json"))
    shutil.rmtree(os.path.dirname(kept))
    print(json.dumps({"audit": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
