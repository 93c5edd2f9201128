"""The batches of a traced stretch, joined to the program's own record of
them: each ``batch#<id>`` scope that lies wholly inside the stretch, with
the ``BatchRecord`` of that id that ``bioinfo1_tpu_torch.utils.tracing``
keeps (its records outlive the mapper).  Empty where the stretch holds no
such scope or the program keeps no such record."""

from __future__ import annotations

import importlib
from typing import List, Tuple

PREFIX = "batch#"


def records() -> dict:
    """{id: record} of the program's batch records; empty without them."""
    try:
        tracing = importlib.import_module("bioinfo1_tpu_torch.utils.tracing")
    except ImportError:
        return {}
    return {r.id: r for r in list(getattr(tracing, "batches", ()))}


def in_stretch(ctx) -> List[Tuple[dict, object]]:
    """[(the batch's scope event, its record)] of the traced stretch."""
    t = ctx.trace
    if t is None:
        return []
    recs = records()
    out = []
    for e in t.scopes:
        name = e["name"]
        if not name.startswith(PREFIX) or not name[len(PREFIX):].isdigit():
            continue
        s = float(e["ts"])
        if t.t0 <= s and s + float(e["dur"]) <= t.t1:
            rec = recs.get(int(name[len(PREFIX):]))
            if rec is not None:
                out.append((e, rec))
    return out
