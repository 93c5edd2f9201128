"""Stage timers and throughput counters (port of bioinfo1_tpu/utils/tracing.py).

``StageTimers.stage`` synchronises the CUDA device before it reads the
clock, so a stage's wall time includes the device work it queued (PyTorch
returns before the card finishes).  ``--profile`` prints these, the
``Counters`` line and the mapper's own counters (pipeline/mapper.py
``MapperCounters``: ``t_fused_s``, ``t_realign_s``, ``t_host_s`` for the
staged host path, ``realign_reroutes``, ``host_fallbacks``, ...).
Profiler hooks are not ported yet.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StageTimers:
    """Named wall-clock accumulators."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
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
