"""CUDA runtime calls that launch a kernel, copy or set memory, made on a
batch's thread inside its ``batch#<id>`` scope (torch's operators and the
port's kernels together), the mean over the batches that ran wholly inside
the traced stretch.  None on a trace without CUDA runtime calls."""

import re
from collections import defaultdict

from benchmark import batches

CALLS = re.compile(r"Launch|Memcpy|Memset")


def read(ctx):
    got = batches.in_stretch(ctx)
    if not got:
        return None
    by_tid = defaultdict(list)
    for e in ctx.trace.runtime.values():
        if e.get("cat") == "cuda_runtime" and CALLS.search(e["name"]):
            by_tid[e["tid"]].append(float(e["ts"]))
    if not by_tid:
        return None
    n = 0
    for e, _r in got:
        s = float(e["ts"])
        end = s + float(e["dur"])
        n += sum(1 for ts in by_tid.get(e["tid"], ()) if s <= ts <= end)
    return n / len(got)
