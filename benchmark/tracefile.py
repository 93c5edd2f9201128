"""Readings of one profiled stretch, from the Chrome trace that
``torch.profiler`` writes.

``busy_by_device`` follows ``chip_smoke.device_time``'s arithmetic (the
union of the device intervals; the profiler's device-side mirrors of
``record_function`` scopes, category ``gpu_user_annotation``, are not
device time), per card.  ``Trace`` adds what the benchmark needs besides:
the stretch's own scope, scope time on one thread, each port kernel's
launch traced back to the benchmark's scope around the call that made it,
and the device's idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Kernel function names of the port's csrc/, as the profiler names them.
PORT_KERNELS = ("lis_chain_kernel", "band_reg_kernel", "band_scratch_kernel",
                "band_strip_kernel", "band_epoch_kernel",
                "band_epoch_merge_kernel", "full_score_kernel",
                "walk_parents_kernel")
STRETCH = "bm.stretch"
CALL_PREFIX = "bm.call#"


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """One stretch's trace.  Times are the trace's microseconds; the
    stretch is the span of the benchmark's ``bm.stretch`` scope;
    ``main_tid`` is the native id of the thread that runs the window."""

    def __init__(self, path: str, main_tid: int) -> None:
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X"]
        stretch = [e for e in events if e.get("cat") == "user_annotation"
                   and e["name"] == STRETCH]
        if not stretch:
            raise RuntimeError("the trace holds no bm.stretch scope")
        s = stretch[0]
        self.t0 = float(s["ts"])
        self.t1 = self.t0 + float(s["dur"])
        self.main_tid = main_tid
        inside = [e for e in events
                  if float(e["ts"]) < self.t1
                  and float(e["ts"]) + float(e.get("dur", 0)) > self.t0]
        self.scopes = [e for e in inside if e.get("cat") == "user_annotation"]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.runtime = {e["args"]["correlation"]: e for e in events
                        if e.get("cat") in ("cuda_runtime", "cuda_driver")
                        and "correlation" in e.get("args", {})}

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clip(self, s: float, e: float) -> Tuple[float, float]:
        return max(s, self.t0), min(e, self.t1)

    def busy_by_device(self) -> Dict[int, List[Tuple[float, float]]]:
        """Per card: its busy intervals inside the stretch, merged."""
        per: dict = defaultdict(list)
        for e in self.device:
            s, t = self._clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            if t > s:
                per[int(e.get("args", {}).get("device", 0))].append((s, t))
        return {d: merge(v) for d, v in per.items()}

    def busy_s(self) -> Dict[int, float]:
        return {d: sum(t - s for s, t in v) / 1e6
                for d, v in self.busy_by_device().items()}

    def scope_s(self, name: str, tid=None) -> float:
        """Seconds inside the stretch that scopes of this name cover (on
        one thread, when ``tid`` is given), clipped to the stretch."""
        spans = [self._clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in self.scopes
                 if e["name"] == name and (tid is None or e["tid"] == tid)]
        return sum(t - s for s, t in merge(spans) if t > s) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time inside the stretch."""
        by: dict = defaultdict(float)
        for e in self.device:
            s, t = self._clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            by[e["name"]] += max(t - s, 0.0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, devices: List[int], top: int = 10) -> List[list]:
        """The device's idle time inside the stretch, summed over the
        cards, by the innermost host scope that had begun last, on any
        thread, at each gap's middle: what the host was doing meanwhile."""
        busy = self.busy_by_device()
        by_tid: dict = defaultdict(list)
        for e in self.scopes:
            if not e["name"].startswith(("bm.", "ProfilerStep")):
                by_tid[e["tid"]].append((float(e["ts"]),
                                         float(e["ts"]) + float(e["dur"]),
                                         e["name"]))
        for v in by_tid.values():
            v.sort()
        by: dict = defaultdict(float)
        for d in devices:
            edges = [self.t0]
            for s, t in busy.get(d, []):
                edges += [s, t]
            edges.append(self.t1)
            for s, t in zip(edges[::2], edges[1::2]):
                if t <= s:
                    continue
                mid = (s + t) / 2
                best = None
                for spans in by_tid.values():
                    i = bisect.bisect_right(spans, (mid, float("inf"), ""))
                    for a, b, name in reversed(spans[max(0, i - 64):i]):
                        if b > mid:
                            if best is None or a > best[0]:
                                best = (a, name)
                            break
                by[best[1] if best else "(no scope)"] += (t - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def call_kernel_s(self) -> Dict[int, float]:
        """{call id: seconds of the port kernels its launches ran}, for the
        benchmark's ``bm.call#<id>`` scopes: a kernel belongs to the scope
        whose External id it carries or, failing that, to the innermost
        such scope that holds its launch on the launching thread."""
        calls = [e for e in self.scopes
                 if e["name"].startswith(CALL_PREFIX)]
        by_ext = {e["args"]["External id"]: e for e in calls
                  if e.get("args", {}).get("External id")}
        by_tid: dict = defaultdict(list)
        for e in calls:
            by_tid[e["tid"]].append((float(e["ts"]),
                                     float(e["ts"]) + float(e["dur"]), e))
        for v in by_tid.values():
            v.sort(key=lambda x: x[0])
        out: Dict[int, float] = defaultdict(float)
        for k in self.device:
            if k.get("cat") != "kernel" or not any(
                    p in k["name"] for p in PORT_KERNELS):
                continue
            args = k.get("args", {})
            scope = by_ext.get(args.get("External id") or None)
            if scope is None:
                rt = self.runtime.get(args.get("correlation"))
                if rt is not None:
                    ts = float(rt["ts"])
                    for a, b, e in reversed(by_tid.get(rt["tid"], [])):
                        if a <= ts <= b:
                            scope = e
                            break
            if scope is not None:
                out[int(scope["name"][len(CALL_PREFIX):])] += (
                    float(k["dur"]) / 1e6)
        return dict(out)
