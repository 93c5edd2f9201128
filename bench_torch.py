#!/usr/bin/env python
"""Benchmark of the PyTorch + CUDA port (bioinfo1_tpu_torch) on one GPU.

    python3 bench_torch.py                      # full size, on the card
    python3 bench_torch.py --platform cpu --tiny

The counterpart of bench.py: the same workloads (seeds, read counts,
lengths and error rates; a synthetic E. coli-scale genome of 4,641,652 bp)
under the same metric names, measured on the port.  Prints ONE JSON line:
{"metric": "reads_per_s_4kb_ecoli", "value", "unit", "vs_baseline": null,
"extra": {...}} with the card's name and power limit in ``extra``.

Measurements, in order:
  measure_ours        the fused map step alone on 4 x 256 reads of 4 kb
  measure_product     the Mapper pipeline: mixed 1.5/3/6 kb score-only,
                      and -c on 4 kb reads
  measure_indel       ONT-profile 2/4/8 kb reads, score-only and -c
  measure_longread    128 x 20 kb score-only and -c, 32 x 50 kb score-only
  measure_cold_start  one pass with the band/budget adaptation reset
  measure_repeat      a repeat-structured genome (the budget ladder, boosts
                      and the staged host path fire), score-only and -c
  measure_sol         the roofline: K6's int32 rate, K2's fill rate, the
                      int32 operations a cell needs and the instructions
                      K2's SASS issues for it
  measure_scaling     tools/measure_scaling.py's strong scaling: N = 1, 2,
                      4, 8 processes under the multi-process variables,
                      one card each while cards are left, each mapping its
                      slice of 8,192 x 1 kb reads and merging to process 0
                      (``extra.scaling``)
  measure_sharded_genome
                      tools/demo_sharded_big_genome.py: a 100 Mb genome
                      whose index auto-shards at a 1e9-byte budget, against
                      the replicated index on the same entries, byte for
                      byte (``extra.sharded_genome``)

Times are host-clock seconds around work that ends synchronised with the
device, or CUDA events for single kernels.  A measurement that raises ends
the run with a non-zero exit.  There is no CPU fallback: without
``--platform cpu`` a missing card is an error.  ``--platform cpu --tiny``
runs every measurement at toy sizes with the kernels' plain versions (K6's
launch excepted); its numbers say nothing about the card and are tagged
``"platform": "cpu"``.  The reference binary is not run here: the
``*_baseline`` ratios divide by its single-thread rate pinned in
BASELINE_MEASURED.json, as bench.py does, and the all-core rate is null.
Scratch files go to build/bench_torch/.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from bioinfo1_tpu_torch.index import builder
import sass_census as sass
from bioinfo1_tpu_torch.kernels import build
from bioinfo1_tpu_torch.ops import band as bd
from bioinfo1_tpu_torch.ops import probe
from bioinfo1_tpu_torch.pipeline import device_map as dm
from bioinfo1_tpu_torch.pipeline.mapper import (Mapper, MapperConfig,
                                                MapperCounters)
from bioinfo1_tpu_torch.utils import simulate as sim

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "bench_torch")
K, W, F = 15, 5, 0.001
SEED = 20250817
SCALING_SEED = 42                   # tools/measure_scaling.py's
SHARDED_SEED = 20260822             # tools/demo_sharded_big_genome.py's
BAND = 128                  # measure_ours: banded score width
BASES = np.frombuffer(b"CATG", dtype=np.uint8)

# Int32 operations the banded score recurrence needs for one cell, whatever
# the kernel: one compare of the two bases, one select of match / mismatch,
# three adds (diagonal + substitution, up + gap, left + gap) and two maxes.
# Borders, the '-' rule, the local clamp and addressing are not counted: a
# leaner kernel may shed them, so a bound that held them would fall with it.
NEEDED_OPS_PER_CELL = 7


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Workload sizes: bench.py's, or toy ones for a CPU run."""

    genome_len: int = 4_641_652     # E. coli K-12 MG1655
    read_len: int = 4096
    n_reads: int = 1024             # measure_ours: 4 device batches
    batch: int = 256
    budget: int = 2048
    mixed: tuple = (1500, 3000, 6000) * 512
    cigar: tuple = (4096,) * 1024
    indel: tuple = (2000, 4000, 8000) * 1024
    long_a: tuple = (20000,) * 128
    long_b: tuple = (50000,) * 32
    cold: tuple = (4000,) * 512
    repeat: tuple = (2000, 4000, 8000) * 171
    repeat_kw: tuple = ()           # repeat_genome overrides, (name, value)
    probe_shape: tuple = (256, 1024)
    probe_iters: tuple = (100, 1100)
    fill_n: int = 8192
    fill_w: int = 1024
    fill_b: int = 512
    warm_passes: int = 5            # at most; stops when adaptation settles
    timed_passes: int = 3           # best of
    scaling_genome: int = 200_000
    scaling_reads: int = 8192
    scaling_read_len: int = 1000
    scaling_procs: tuple = (1, 2, 4, 8)
    scaling_k: int = K
    sharded_genome: int = 100_000_000
    sharded_reads: int = 64
    sharded_read_len: int = 4000
    sharded_entries: int = 8        # dealt over the cards (two of one)
    sharded_budget: str = "1e9"
    sharded_k: int = K
    tiny: bool = False


FULL = Sizes()
TINY = Sizes(genome_len=40_000, read_len=256, n_reads=8, batch=4, budget=256,
             mixed=(150, 300, 450) * 2, cigar=(300,) * 4,
             indel=(200, 300, 450) * 2, long_a=(900,) * 2, long_b=(1300,),
             cold=(300,) * 4, repeat=(200, 300, 450) * 2,
             repeat_kw=(("is_elements", 6), ("is_len", 200),
                        ("rrn_operons", 3), ("rrn_len", 400),
                        ("tandem_loci", 3), ("tandem_unit", 30),
                        ("tandem_copies", 4)),
             probe_shape=(8, 128), probe_iters=(2, 5), fill_n=128,
             fill_w=128, fill_b=4, warm_passes=1, timed_passes=1,
             scaling_genome=20_000, scaling_reads=48, scaling_read_len=300,
             scaling_procs=(1, 2), scaling_k=11, sharded_genome=40_000,
             sharded_reads=4, sharded_read_len=400, sharded_entries=2,
             sharded_budget="1e3", sharded_k=11, tiny=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_data(sizes: Sizes = FULL):
    """Genome and ``n_reads`` fixed-length reads with 2% point errors."""
    rng = np.random.default_rng(SEED)
    genome = BASES[rng.integers(0, 4, sizes.genome_len)]
    L = sizes.read_len
    reads = np.zeros((sizes.n_reads, L), dtype=np.uint8)
    for i in range(sizes.n_reads):
        start = int(rng.integers(0, sizes.genome_len - L))
        r = genome[start:start + L].copy()
        nmut = int(L * 0.02)
        pos = rng.integers(0, L, nmut)
        r[pos] = BASES[rng.integers(0, 4, nmut)]
        reads[i] = r
    lens = np.full((sizes.n_reads,), L, dtype=np.int32)
    return genome, reads, lens


def measure_ours(genome, reads, lens, device: torch.device,
                 sizes: Sizes = FULL):
    """reads/s through the fused map step alone (``map_step``, band 128,
    global): every batch resident on the device, one synchronise per pass.
    Returns (reads_per_s, mapped, index_s, gcups, band_vs_full_parity)."""
    t0 = time.perf_counter()
    index = builder.build_index(genome.tobytes().decode("latin1"), K, W, F)
    didx = dm.device_index_from_host(index, device)
    _sync(device)
    t_index = time.perf_counter() - t0
    reads_d = torch.from_numpy(reads).to(device)
    lens_d = torch.from_numpy(lens).to(device)
    kw = dict(k=K, w=W, mode=0, budget=sizes.budget,
              region_cap=2 * sizes.read_len)

    def full_pass():
        _sync(device)
        t0 = time.perf_counter()
        mapped = torch.zeros((), dtype=torch.int64, device=device)
        cells = torch.zeros((), dtype=torch.float64, device=device)
        for i in range(0, sizes.n_reads, sizes.batch):
            out = dm.map_step(reads_d[i:i + sizes.batch],
                              lens_d[i:i + sizes.batch], didx, 1, -1, -1,
                              band=BAND, **kw)
            mapped += out.mapped.sum()
            cells += torch.where(
                out.mapped, (out.q_end - out.q_begin + 1).double()
                * (out.t_end - out.t_begin + 1), 0.0).sum()
        _sync(device)
        return time.perf_counter() - t0, int(mapped), float(cells)

    full_pass()                                     # warm-up
    dt, mapped, cells = full_pass()
    if not sizes.tiny:
        dt = min(dt, full_pass()[0])
    # One batch through the banded kernel against the full-matrix kernel:
    # every certified read must carry the same fields.
    a = dm.map_step(reads_d[:sizes.batch], lens_d[:sizes.batch], didx, 1, -1,
                    -1, band=BAND, **kw).to_numpy()
    b = dm.map_step(reads_d[:sizes.batch], lens_d[:sizes.batch], didx, 1, -1,
                    -1, band=0, **kw).to_numpy()
    ok = ~a.inexact
    parity = all(bool(np.array_equal(getattr(a, f)[ok], getattr(b, f)[ok]))
                 for f in ("mapped", "is_fwd", "q_begin", "q_end", "t_begin",
                           "t_end", "score", "overflow"))
    return sizes.n_reads / dt, mapped, t_index, cells / dt / 1e9, parity


def make_product_mapper(genome, device: torch.device) -> Mapper:
    """One shared Mapper for the product-path measurements: each Mapper
    holds its own device index (a 4 GB directory at k = 15)."""
    return Mapper([("ref", genome.tobytes().decode("latin1"))],
                  MapperConfig(), device=device)


def _settle(mapper: Mapper, records, passes: int) -> None:
    """Warm passes until the adaptive bands and budget boosts stop moving."""
    for _ in range(passes):
        before = (dict(mapper._band_by_key), dict(mapper._budget_boost))
        mapper.map_records(records)
        if (dict(mapper._band_by_key), dict(mapper._budget_boost)) == before:
            break


def _timed(mapper: Mapper, records, sizes: Sizes, min_mapped: float):
    """(best seconds of ``timed_passes`` passes, the first pass's counters)
    after the warm passes; fails when too few reads map."""
    _settle(mapper, records, sizes.warm_passes)
    mapper.counters = MapperCounters()
    best, counters = None, None
    for _ in range(sizes.timed_passes):
        _sync(mapper.device)
        t0 = time.perf_counter()
        lines = mapper.map_records(records)
        _sync(mapper.device)
        dt = time.perf_counter() - t0
        if counters is None:
            counters = mapper.counters.as_dict()
        best = dt if best is None else min(best, dt)
    if len(lines) < len(records) * min_mapped:
        raise RuntimeError(f"too few reads mapped: {len(lines)} of "
                           f"{len(records)}")
    return best, counters


def _point_error_reads(genome, lengths, rng):
    recs = []
    for i, ln in enumerate(lengths):
        start = int(rng.integers(0, len(genome) - ln))
        r = genome[start:start + ln].copy()
        pos = rng.integers(0, ln, ln // 50)
        r[pos] = BASES[rng.integers(0, 4, len(pos))]
        recs.append((f"r{i}", r.tobytes().decode("latin1")))
    return recs


def measure_product(genome, mapper: Mapper, sizes: Sizes = FULL):
    """The bucketed Mapper pipeline the CLI runs: (a) mixed-length
    score-only mapping (three buckets), (b) -c on fixed-length reads.
    Returns (mixed_reads_per_s, mixed_bases_per_s, cigar_reads_per_s)."""
    rng = np.random.default_rng(SEED + 1)
    mixed = _point_error_reads(genome, sizes.mixed, rng)
    cig = _point_error_reads(genome, sizes.cigar, rng)
    one = dataclasses.replace(sizes, timed_passes=1)
    mapper.cfg = MapperConfig()
    dt_mixed, _ = _timed(mapper, mixed, one, 0.9)
    mapper.cfg = MapperConfig(output_cigar=True)
    dt_cig, _ = _timed(mapper, cig, one, 0.9)
    mapper.cfg = MapperConfig()
    return (len(mixed) / dt_mixed,
            sum(len(s) for _, s in mixed) / dt_mixed, len(cig) / dt_cig)


def measure_indel(genome, mapper: Mapper, sizes: Sizes = FULL) -> dict:
    """ONT-profile reads (~12% error with indels), mixed lengths, through
    the Mapper pipeline, score-only and -c."""
    rng = np.random.default_rng(SEED + 2)
    records = sim.simulate_reads(genome, sizes.indel, rng)
    mapper.cfg = MapperConfig()
    dt_s, score_counters = _timed(mapper, records, sizes, 0.9)
    mapper.cfg = MapperConfig(output_cigar=True)
    dt_c, cigar_counters = _timed(mapper, records, sizes, 0.9)
    mapper.cfg = MapperConfig()
    return {"indel_reads_per_s": len(records) / dt_s,
            "indel_counters": score_counters,
            "cigar_indel_reads_per_s": len(records) / dt_c,
            "cigar_indel_counters": cigar_counters,
            "cigar_indel_pct_of_score": round(100 * dt_s / dt_c, 1)}


def measure_longread(genome, mapper: Mapper, sizes: Sizes = FULL) -> dict:
    """Long ONT-profile reads through the Mapper pipeline: 20 kb score-only
    and -c, 50 kb score-only."""
    rng = np.random.default_rng(SEED + 7)
    recs20 = sim.simulate_reads(genome, sizes.long_a, rng)
    recs50 = sim.simulate_reads(genome, sizes.long_b, rng)
    two = dataclasses.replace(sizes, timed_passes=min(2, sizes.timed_passes),
                              warm_passes=min(4, sizes.warm_passes))

    def rate(records, cfg):
        mapper.cfg = cfg
        dt, counters = _timed(mapper, records, two, 0.9)
        return (len(records) / dt, sum(len(s) for _, s in records) / dt,
                counters)

    r20, b20, _ = rate(recs20, MapperConfig())
    r20c, _, _ = rate(recs20, MapperConfig(output_cigar=True))
    r50, b50, counters50 = rate(recs50, MapperConfig())
    mapper.cfg = MapperConfig()
    return {"longread_20k_reads_per_s": round(r20, 2),
            "longread_20k_bases_per_s": round(b20),
            "longread_20k_cigar_reads_per_s": round(r20c, 2),
            "longread_50k_reads_per_s": round(r50, 2),
            "longread_50k_bases_per_s": round(b50),
            "longread_50k_counters": counters50}


def measure_cold_start(genome, mapper: Mapper, sizes: Sizes = FULL) -> dict:
    """First-run throughput with the band/budget adaptation state reset:
    one cold pass, the learned state restored afterwards."""
    rng = np.random.default_rng(SEED + 8)
    records = sim.simulate_reads(genome, sizes.cold, rng)
    saved = dict(mapper._band_by_key), dict(mapper._budget_boost)
    mapper.cfg = MapperConfig()
    try:
        mapper._band_by_key.clear()
        mapper._budget_boost.clear()
        _sync(mapper.device)
        t0 = time.perf_counter()
        lines = mapper.map_records(records)
        _sync(mapper.device)
        dt = time.perf_counter() - t0
    finally:
        for live, old in zip((mapper._band_by_key, mapper._budget_boost),
                             saved):
            live.clear()
            live.update(old)
    if len(lines) < len(records) * 9 // 10:
        raise RuntimeError("too few cold-start reads mapped")
    return {"cold_start_reads_per_s": round(len(records) / dt, 2)}


def measure_repeat(sizes: Sizes = FULL,
                   device: Optional[torch.device] = None) -> dict:
    """A repeat-structured genome at product scale
    (``utils/simulate.repeat_genome``: insertion sequences, rRNA operons,
    tandem loci), so the frequency ban, the budget-overflow ladder, the
    bucket boosts and repeat-dense chains fire; half the reads at ~12%
    error, half at ~3%.  Builds its own index: drop any other mapper
    first.  Score-only, then -c."""
    device = device or torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 5)
    genome = sim.repeat_genome(sizes.genome_len, rng,
                               **dict(sizes.repeat_kw))
    records = sim.simulate_reads(genome, sizes.repeat, rng)
    records += sim.simulate_reads(genome, sizes.repeat, rng, sub_rate=0.015,
                                  ins_rate=0.007, del_rate=0.008)
    mapper = Mapper([("ref", genome.tobytes().decode("latin1"))],
                    MapperConfig(), device=device)
    two = dataclasses.replace(sizes, timed_passes=min(2, sizes.timed_passes),
                              warm_passes=min(4, sizes.warm_passes))
    # The warm passes are where the budget ladder and the boosts work: keep
    # their counters beside those of the first timed pass.
    _settle(mapper, records, two.warm_passes)
    warm_counters = mapper.counters.as_dict()
    timed = dataclasses.replace(two, warm_passes=0)
    dt, counters = _timed(mapper, records, timed, 0.8)
    mapper.cfg = MapperConfig(output_cigar=True)
    dt_c, cigar_counters = _timed(mapper, records, two, 0.8)
    return {"repeat_reads_per_s": len(records) / dt,
            "repeat_cigar_reads_per_s": len(records) / dt_c,
            "repeat_counters": counters,
            "repeat_warm_counters": warm_counters,
            "repeat_cigar_counters": cigar_counters,
            "repeat_budget_boost": {str(k): v for k, v
                                    in mapper._budget_boost.items()},
            "repeat_reads": len(records)}


def band_cells(q_lens: torch.Tensor, t_lens: torch.Tensor, W: int) -> int:
    """Cells of each pair's q_len x t_len matrix that lie in a W-lane band
    (diagonal offsets j - i in [-W, W - 1]), summed over the pairs: the
    cells a banded DP has to compute, without the band lanes that hang off
    the matrix at its corners and past a short read's last row."""
    if not q_lens.numel():
        return 0
    ql, tl = q_lens.long()[:, None], t_lens.long()[:, None]
    i = torch.arange(1, int(q_lens.max()) + 1, device=q_lens.device)[None, :]
    row = (torch.minimum(tl, i + (W - 1)) - (i - W).clamp(min=1) + 1)
    return int(row.clamp(min=0)[i <= ql].sum())


def _event_ms(fn, device: torch.device) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop)


def nvidia_smi(fields: str) -> str:
    """First line of ``nvidia-smi --query-gpu=<fields>``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# Add and max instructions as the probe's trip may issue them.
_ADD_MAX_OPS = ("IADD3", "VIADD", "IMAD", "VIMNMX", "IMNMX", "VIADDMNMX")


def probe_census(listing: str) -> dict:
    """The int32 probe's trip loop in the SASS: its add and max
    instructions.  The body must hold ILP * UNROLL adds and as many maxes,
    or as many fused add-max instructions: anything less means the
    compiler folded the probe."""
    loop = sass.cell_loops(listing, "int32_probe_kernel")[0]
    steps = probe.ILP * probe.UNROLL
    ops = {k: v for k, v in loop["by_op"].items() if k in _ADD_MAX_OPS}
    fused = ops.get("VIADDMNMX", 0)
    maxes = ops.get("VIMNMX", 0) + ops.get("IMNMX", 0) + fused
    adds = sum(ops.get(k, 0) for k in ("IADD3", "VIADD", "IMAD")) + fused
    if maxes < steps or adds < steps:
        raise RuntimeError(f"the probe's loop body was folded: {ops} for "
                           f"{steps} add/max steps")
    return {"loop": [loop["first"], loop["last"]],
            "instructions": loop["instructions"], "add_max_ops": ops,
            "issued_per_trip": sum(ops.values())}


def measure_sol(sizes: Sizes = FULL,
                device: Optional[torch.device] = None) -> dict:
    """The roofline of the DP kernels on this card.

    (a) K6: sustained int32 add/max rate, by CUDA events over the
    difference of two trip counts after two warm-up launches each, as
    source operations (2 per step) and as issued instructions (counted in
    the kernel's SASS).  (b) K2's band-cell fill rate at the 8 kb -c shape
    (global, ``dash_free`` and general), input varied per repetition,
    cells = B * (q_len + t_len) * W, every lane of every diagonal.  (c) the
    int32 instructions K2 issues per cell: the integer instructions in the
    SASS of the interior pair loop of the kernel that served (b), over the
    2 * LPT cells one trip computes (``sass_census.band_interior_loop``):
    ``gcups_sol_pct`` = (b) / ((a, issued) / (c)), the share of the
    card's issue rate this kernel's own instruction stream uses.  (d) what
    the function needs: ``gcups_needed_pct`` = matrix cells inside the band
    (``band_cells``) per second / ((a, issued) / NEEDED_OPS_PER_CELL), the
    share of the rate at which the card could fill these cells.  (d) is
    the one that stays put when the kernel changes.

    On a CPU tensor the probe's plain version is only held to its closed
    form and every rate is null."""
    device = device or torch.device("cuda", 0)
    x = torch.ones(sizes.probe_shape, dtype=torch.int32, device=device)
    n1, n2 = sizes.probe_iters
    out = {"int32_tops": None, "int32_issued_tops": None,
           "band_cells_per_s_g": None, "band_cells_per_s_g_general": None,
           "ops_per_cell": None, "gcups_sol_pct": None,
           "needed_ops_per_cell": NEEDED_OPS_PER_CELL,
           "gcups_needed_pct": None}
    for n in (n1, n2):
        got = probe.int32_probe(x, n)
        if not torch.equal(got, x + 4 + 16 * n * (n - 1)):
            raise RuntimeError(f"int32 probe wrong at n_iter = {n}")
    rng = np.random.default_rng(SEED)
    n, Wf, B = sizes.fill_n, sizes.fill_w, sizes.fill_b
    q = torch.from_numpy(BASES[rng.integers(0, 4, (B, n))]).to(device)
    t = torch.from_numpy(BASES[rng.integers(0, 4, (B, 2 * n))]).to(device)
    ql = torch.full((B,), n, dtype=torch.int32, device=device)
    tl = torch.full((B,), n + Wf // 2, dtype=torch.int32, device=device)
    qs = [q, q ^ 1]                     # input varied per repetition

    def fill(i, dash_free):
        return bd.align_scores_banded(qs[i % 2], ql, t, tl, 1, -1, -1,
                                      band=Wf, mode=0, dash_free=dash_free)

    if device.type != "cuda":
        fill(0, True), fill(1, False)
        return out

    def probe_ms(n_iter):
        probe.int32_probe(x, n_iter)
        probe.int32_probe(x, n_iter)
        torch.cuda.synchronize(device)
        return _event_ms(lambda: probe.int32_probe(x, n_iter), device)

    d1, d2 = probe_ms(n1), probe_ms(n2)
    clocks = nvidia_smi("clocks.sm,clocks.max.sm,power.draw")
    dt = max(d2 - d1, 1e-6) * 1e-3
    listing = build.sass()
    census = probe_census(listing)
    src_rate = probe.source_ops(x.numel(), n2 - n1) / dt
    issued_rate = x.numel() * (n2 - n1) * census["issued_per_trip"] / dt

    def fill_s(dash_free, reps=4):
        fill(0, dash_free), fill(1, dash_free)
        torch.cuda.synchronize(device)
        return _event_ms(lambda: [fill(i, dash_free) for i in range(reps)],
                         device) * 1e-3 / reps

    cells = B * (2 * n + Wf // 2) * Wf
    dt_fill = fill_s(True)
    cps, cps_gen = cells / dt_fill, cells / fill_s(False)
    m_eff = bd.band_shapes(n, 2 * n, Wf)[2]
    needed_cps = band_cells(ql, tl.clamp(max=m_eff), Wf) / dt_fill
    # The kernel that served the fill: its interior pair loop computes
    # 2 * LPT cells a trip.
    plan = bd.band_plan(Wf, B, False)
    loop = sass.band_interior_loop(
        listing, sass.plan_needle(plan, False), plan.lpt)
    ops_per_cell = loop["int_per_cell"]
    out.update(
        int32_tops=round(src_rate / 1e12, 3),
        int32_issued_tops=round(issued_rate / 1e12, 3),
        band_cells_per_s_g=round(cps / 1e9, 1),
        band_cells_per_s_g_general=round(cps_gen / 1e9, 1),
        ops_per_cell=ops_per_cell,
        gcups_sol_pct=round(100 * cps / (issued_rate / ops_per_cell), 1),
        band_matrix_cells_per_s_g=round(needed_cps / 1e9, 1),
        gcups_needed_pct=round(
            100 * needed_cps / (issued_rate / NEEDED_OPS_PER_CELL), 1),
        issued_over_needed=round(ops_per_cell / NEEDED_OPS_PER_CELL, 2),
        probe_ms=[d1, d2], probe_sass=census,
        band_plan=dataclasses.asdict(plan),
        cell_loops=[{k: loop[k] for k in ("first", "last", "instructions",
                                          "by_kind", "cells_per_trip")}],
        clocks_sm_max_power_draw=clocks)
    return out


# ---- several processes (measure_scaling; chip_smoke.py's phases 2p, 2q) ---

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_processes(n: int, argv_of, base_of, env_of) -> list:
    """n processes of this interpreter (fork + exec, never a fork of a CUDA
    process) under one coordinator address and merge port, the
    multi-process variables of the JAX package (JAX_COORDINATOR_ADDRESS=
    127.0.0.1:<free port>, JAX_NUM_PROCESSES, JAX_PROCESS_ID) and
    BIOINFO1_MERGE_PORT: process p runs ``argv_of(p)`` with ``env_of(p)``
    added to its environment (CUDA_VISIBLE_DEVICES), its stdout and stderr
    going to ``base_of(p)`` + ``.out`` / ``.err``.  Returns [(Popen,
    base)]."""
    coord, merge = free_port(), free_port()
    procs = []
    for p in range(n):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(p),
                   BIOINFO1_MERGE_PORT=str(merge), **env_of(p))
        base = base_of(p)
        with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
            procs.append((subprocess.Popen(
                [sys.executable, *argv_of(p)], env=env, cwd=REPO,
                stdout=out, stderr=err), base))
    return procs


def stop_processes(procs, timeout: float) -> None:
    """Wait for every process up to ``timeout`` s in all; kill the rest."""
    deadline = time.time() + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(0.1, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _tail(path: str, n: int = 3000) -> str:
    with open(path) as fh:
        return fh.read()[-n:]


def scaling_genome(n: int) -> str:
    """tools/measure_scaling.py's genome: n bases from seed 42."""
    rng = np.random.default_rng(SCALING_SEED)
    return BASES[rng.integers(0, 4, n)].tobytes().decode("latin1")


def write_scaling_reads(path: str, sizes: Sizes) -> None:
    """tools/measure_scaling.py's reads file, draw for draw: the genome from
    seed 42, then per read a start and read_len / 50 substitutions (2%)."""
    rng = np.random.default_rng(SCALING_SEED)
    genome = BASES[rng.integers(0, 4, sizes.scaling_genome)]
    L = sizes.scaling_read_len
    with open(path, "w") as fh:
        for r in range(sizes.scaling_reads):
            start = int(rng.integers(0, len(genome) - L))
            seq = genome[start:start + L].copy()
            for e in rng.integers(0, L, L // 50):
                seq[e] = BASES[int(rng.integers(0, 4))]
            fh.write(f">r{r}\n{seq.tobytes().decode('latin1')}\n")


def scaling_worker(spec: dict) -> int:
    """One process of ``measure_scaling`` (tools/scaling_worker.py's
    product path): the sliced parse, a warm-up batch, then three timed
    repetitions of Mapper.map_records plus the MergeSession gather to
    process 0, each on its own merge port and after a barrier (a gloo group
    at the coordinator address).  Process 0 writes the medians to
    ``spec["out"]``."""
    import torch.distributed as dist

    from bioinfo1_tpu_torch.io import fastx
    from bioinfo1_tpu_torch.parallel import shard as ps
    from bioinfo1_tpu_torch.utils.runtime import resolve_device
    p, n = ps.process_index(), ps.process_count()
    device = resolve_device()
    cfg = MapperConfig(batch_size=64, devices=1, k=spec["k"])
    mapper = Mapper([("ref", scaling_genome(spec["genome_len"]))], cfg,
                    device=device)
    if n > 1:
        dist.init_process_group(
            "gloo", init_method="tcp://" + os.environ[
                "JAX_COORDINATOR_ADDRESS"], rank=p, world_size=n)
    t0 = time.perf_counter()
    if n > 1:
        _, total = fastx.parse_reads_slice(spec["reads"], 0, 0)
        lo, hi = ps.process_read_slice(total)
        reads, _ = fastx.parse_reads_slice(spec["reads"], lo, hi)
    else:
        reads = fastx.parse_reads(spec["reads"])
        total = len(reads.records)
    parse_s = time.perf_counter() - t0
    local = reads.records
    mapper.map_records(local[:cfg.batch_size])          # warm-up
    map_ts, merge_ts, merged = [], [], None
    for port in spec["merge_ports"]:
        merge = None
        if n > 1:
            os.environ["BIOINFO1_MERGE_PORT"] = str(port)
            merge = ps.MergeSession()
            dist.barrier()
        t0 = time.perf_counter()
        lines = mapper.map_records(local)
        _sync(device)
        t1 = time.perf_counter()
        merged = merge.gather(lines) if merge else list(lines)
        merge_ts.append(time.perf_counter() - t1)
        map_ts.append(t1 - t0)
        if merge:
            merge.close()
    if n > 1:
        dist.destroy_process_group()
    if p == 0:
        if len(merged) < total * 9 // 10:
            raise RuntimeError(f"only {len(merged)} of {total} reads mapped")
        map_s, merge_s = statistics.median(map_ts), statistics.median(merge_ts)
        with open(spec["out"], "w") as fh:
            json.dump({"nproc": n, "n_reads": total, "parse_s": parse_s,
                       "map_only_s": map_s, "merge_s": merge_s,
                       "map_s": map_s + merge_s,
                       "reads_per_s": total / (map_s + merge_s),
                       "mapped": len(merged), "map_only_runs_s": map_ts,
                       "merge_runs_s": merge_ts}, fh)
    return 0


def measure_scaling(sizes: Sizes, device: torch.device) -> dict:
    """Strong scaling of the multi-process product path (tools/
    measure_scaling.py with the port's processes): for each N, N
    ``scaling_worker`` processes, process p on card p mod cards (the cards
    shared round-robin once N exceeds them: ``oversubscribed``; on the CPU
    the cores).  efficiency(N) = T1 / (N * TN) over parse + map + merge,
    and over the map alone."""
    os.makedirs(WORK, exist_ok=True)
    reads = os.path.join(WORK, "scaling_reads.fasta")
    write_scaling_reads(reads, sizes)
    on_card = device.type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    slots = cards if on_card else (os.cpu_count() or 1)

    def env_of(p):
        return ({"CUDA_VISIBLE_DEVICES": str(p % cards)} if on_card
                else {"BIOINFO1_PLATFORM": "cpu"})
    configs = {}
    for n in sizes.scaling_procs:
        out = os.path.join(WORK, f"scaling_{n}.json")
        spec = {"out": out, "reads": reads, "genome_len":
                sizes.scaling_genome, "k": sizes.scaling_k,
                "merge_ports": [free_port() for _ in range(3)]}
        procs = start_processes(
            n, lambda p: [os.path.join(REPO, "bench_torch.py"),
                          "--scaling-worker", json.dumps(spec)],
            lambda p: os.path.join(WORK, f"scaling_{n}.p{p}"), env_of)
        stop_processes(procs, 1200)
        for proc, base in procs:
            if proc.returncode != 0:
                raise RuntimeError(f"scaling worker {base} rc "
                                   f"{proc.returncode}: {_tail(base + '.err')}")
        with open(out) as fh:
            configs[n] = json.load(fh)
        configs[n]["oversubscribed"] = n > slots

    def total(r):
        return r["parse_s"] + r["map_only_s"] + r["merge_s"]
    first = configs[sizes.scaling_procs[0]]
    return {
        "workload": f"{sizes.scaling_reads} x {sizes.scaling_read_len} bp "
                    f"reads at 2% substitutions against a "
                    f"{sizes.scaling_genome} bp random genome (seed 42), "
                    f"k={sizes.scaling_k} w={W} f={F}, batch 64, product "
                    "path (sliced parse + Mapper + MergeSession gather)",
        "method": "strong scaling, one process per host, process p on card "
                  "p mod cards; eff(N) = T1/(N*TN); oversubscribed = more "
                  "processes than cards (on the CPU: cores)",
        "cards": cards, "platform": device.type,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "nvidia_smi": nvidia_smi("name,power.limit") if on_card else None,
        "configs": {str(n): r for n, r in configs.items()},
        "efficiency": {str(n): total(first) / (n * total(r))
                       for n, r in configs.items()},
        "efficiency_map_only": {
            str(n): first["map_only_s"] / (n * r["map_only_s"])
            for n, r in configs.items()}}


def sharded_genome_workload(sizes: Sizes):
    """tools/demo_sharded_big_genome.py's genome (seed 20260822) and reads
    (``sharded_reads`` of ``sharded_read_len`` at 2% substitutions), draw
    for draw."""
    rng = np.random.default_rng(SHARDED_SEED)
    genome = BASES[rng.integers(0, 4, sizes.sharded_genome)]
    records = _point_error_reads(
        genome, [sizes.sharded_read_len] * sizes.sharded_reads, rng)
    return genome.tobytes().decode("latin1"), records


LOOKUP_FIELDS = ("key_hash", "key_pos", "cnt_fr", "cnt_r2", "bucket_off")


def lookup_bytes(didx: dm.DeviceIndex) -> int:
    """Bytes of one index copy's or shard's lookup arrays (its reference
    bytes apart, which every entry holds either way)."""
    return sum(getattr(didx, f).nbytes for f in LOOKUP_FIELDS)


def measure_sharded_genome(sizes: Sizes, device: torch.device) -> dict:
    """The big-genome sharded index (tools/demo_sharded_big_genome.py):
    ``sharded_entries`` entries dealt over the local cards in turn (two of
    ``cuda:0`` on a one-card host; two of the CPU in a CPU run), the index
    under BIOINFO1_INDEX_SHARD=auto with BIOINFO1_INDEX_BUDGET lowered so
    that ``mapper._index_shard_count`` itself shards, then the same mapper
    (the same host index, fresh bands) with its index placed replicated
    under BIOINFO1_INDEX_SHARD=0: both PAFs must be byte-identical.  Lookup
    bytes per entry and per card, the cards' peak memory, build and map
    seconds."""
    from bioinfo1_tpu_torch.pipeline import mapper as mp
    on_card = device.type == "cuda"
    if on_card and torch.cuda.device_count() > 1:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        entries = [cards[i % len(cards)]
                   for i in range(sizes.sharded_entries)]
    else:
        entries = [device] * 2
    genome, records = sharded_genome_workload(sizes)
    cfg = MapperConfig(k=sizes.sharded_k)
    saved = {k: os.environ.get(k)
             for k in ("BIOINFO1_INDEX_SHARD", "BIOINFO1_INDEX_BUDGET")}

    def peaks():
        return ({str(d): torch.cuda.max_memory_allocated(d)
                 for d in dict.fromkeys(entries)} if on_card else None)

    def passes():
        if on_card:
            for d in dict.fromkeys(entries):
                torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        mapper.device_index()
        for d in dict.fromkeys(entries):
            _sync(d)
        t_place = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines = mapper.map_records(records)
        for d in dict.fromkeys(entries):
            _sync(d)
        return lines, t_place, time.perf_counter() - t0, peaks()

    try:
        os.environ["BIOINFO1_INDEX_SHARD"] = "auto"
        os.environ["BIOINFO1_INDEX_BUDGET"] = sizes.sharded_budget
        t0 = time.perf_counter()
        mapper = Mapper([("ref", genome)], cfg, devices=entries)
        t_build = time.perf_counter() - t0
        n_entries = (len(mapper.index.fwd.hash_sorted)
                     + len(mapper.index.rev.hash_sorted))
        engaged = mp._index_shard_count(cfg.k, n_entries, len(entries))
        if engaged != len(entries):
            raise RuntimeError(f"auto-sharding did not engage: "
                               f"{engaged} shards for {len(entries)} entries")
        sharded, t_place_s, t_sharded, peak_s = passes()
        index = mapper.device_index()
        if not isinstance(index, dm.ShardedIndex):
            raise RuntimeError("the index was not placed sharded")
        shard_b = [lookup_bytes(s) for s in index.shards]
        del index
        mapper._device_index = None         # the same host index, replicated
        mapper._band_by_key.clear()
        mapper._budget_boost.clear()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        os.environ["BIOINFO1_INDEX_SHARD"] = "0"
        replicated, t_place_r, t_repl, peak_r = passes()
        copies = mapper._device_index
        rep_b = lookup_bytes(next(iter(copies.values())))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    identical = sharded == replicated
    if not identical:
        raise RuntimeError("the sharded index's PAF differs from the "
                           "replicated index's")
    del mapper, copies
    gc.collect()
    by_card: dict = {}
    for d, b in zip(entries, shard_b):
        by_card[str(d)] = by_card.get(str(d), 0) + b
    if on_card:
        torch.cuda.empty_cache()
    return {
        "genome_mb": sizes.sharded_genome / 1e6, "n_reads": len(records),
        "read_len": sizes.sharded_read_len, "k": cfg.k,
        "budget": sizes.sharded_budget,
        "entries": [str(d) for d in entries],
        "n_index_entries": n_entries,
        "auto_shards_engaged": engaged,
        "per_device_lookup_bytes_replicated": rep_b,
        "per_device_lookup_bytes_sharded": max(shard_b),
        "per_entry_lookup_bytes_sharded": shard_b,
        "per_card_lookup_bytes_replicated": {
            str(d): rep_b for d in dict.fromkeys(entries)},
        "per_card_lookup_bytes_sharded": by_card,
        "shard_reduction_x": rep_b / max(shard_b),
        "card_reduction_x": rep_b / max(by_card.values()),
        "peak_bytes_sharded": peak_s, "peak_bytes_replicated": peak_r,
        "mapped_sharded": len(sharded),
        "output_identical_to_replicated": identical,
        "t_index_build_s": t_build,
        "t_place_sharded_s": t_place_s, "t_place_replicated_s": t_place_r,
        "t_map_sharded_s": t_sharded, "t_map_replicated_s": t_repl,
        "platform": device.type,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "nvidia_smi": nvidia_smi("name,power.limit") if on_card else None}


def pinned_baseline() -> dict:
    """The reference C++ mapper's single-thread reads/s on 2,048 x 4 kb
    reads, pinned in BASELINE_MEASURED.json (bench.py's measure_baseline,
    pinned branch); read, never written."""
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as fh:
        return json.load(fh)


def printed_ratio(rate: float, base: float) -> tuple:
    """(rate, rate / base) as printed, each to two decimals; the ratio
    divides the printed rate, so that it is the ratio of the printed
    numbers (dividing the unrounded rate can round the other way)."""
    shown = round(rate, 2)
    return shown, round(shown / base, 2)


def run_measurement(sizes: Sizes, device: torch.device) -> dict:
    """Every measurement in order; returns the result object."""
    genome, reads, lens = make_data(sizes)
    ours, mapped, t_index, gcups, parity = measure_ours(genome, reads, lens,
                                                        device, sizes)
    mapper = make_product_mapper(genome, device)
    mixed_rps, mixed_bps, cigar_rps = measure_product(genome, mapper, sizes)
    indel = measure_indel(genome, mapper, sizes)
    longread = measure_longread(genome, mapper, sizes)
    cold = measure_cold_start(genome, mapper, sizes)
    # Free the random genome's device index before the repeat genome's.
    del mapper
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    repeat = measure_repeat(sizes, device)
    sol = measure_sol(sizes, device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    scaling = measure_scaling(sizes, device)
    sharded = measure_sharded_genome(sizes, device)
    on_card = device.type == "cuda"
    base = pinned_baseline()["reads_per_s"]
    value, vs_base = printed_ratio(ours, base)
    indel_rps, indel_vs = printed_ratio(indel["indel_reads_per_s"], base)
    repeat_rps, repeat_vs = printed_ratio(repeat["repeat_reads_per_s"], base)
    return {
        "metric": "reads_per_s_4kb_ecoli", "value": value,
        "unit": "reads/s", "vs_baseline": vs_base,
        "extra": {
            "mapped": mapped, "n_reads": sizes.n_reads,
            "index_build_s": round(t_index, 2), "gcups": round(gcups, 3),
            "band_vs_full_parity": parity,
            "product_mixed_reads_per_s": round(mixed_rps, 2),
            "product_mixed_bases_per_s": round(mixed_bps),
            "cigar_reads_per_s": round(cigar_rps, 2),
            "indel_reads_per_s": indel_rps,
            "indel_vs_baseline": indel_vs,
            "indel_counters": indel["indel_counters"],
            "cigar_indel_reads_per_s":
                round(indel["cigar_indel_reads_per_s"], 2),
            "cigar_indel_pct_of_score": indel["cigar_indel_pct_of_score"],
            "cigar_indel_counters": indel["cigar_indel_counters"],
            "repeat_reads_per_s": repeat_rps,
            "repeat_cigar_reads_per_s":
                round(repeat["repeat_cigar_reads_per_s"], 2),
            "repeat_vs_baseline": repeat_vs,
            "repeat_counters": repeat["repeat_counters"],
            "repeat_warm_counters": repeat["repeat_warm_counters"],
            "repeat_cigar_counters": repeat["repeat_cigar_counters"],
            "repeat_budget_boost": repeat["repeat_budget_boost"],
            "longread": longread,
            "cold_start_reads_per_s": cold["cold_start_reads_per_s"],
            "sol": sol,
            "platform": device.type, "tiny": sizes.tiny,
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
            "nvidia_smi": nvidia_smi("name,power.limit") if on_card else None,
            "baseline_reads_per_s": round(base, 3),
            "baseline_omp_reads_per_s": None,
            "baseline_note": "the *_baseline ratios divide by the reference "
                             "C++ mapper's single-thread reads/s pinned in "
                             "BASELINE_MEASURED.json (2,048 x 4 kb reads), "
                             "not measured on this host; its all-core rate "
                             "is not measured",
            "scaling": scaling, "sharded_genome": sharded,
        }}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="toy sizes (for a CPU run)")
    ap.add_argument("--scaling-worker", metavar="SPEC",
                    help="run one process of measure_scaling (JSON spec)")
    args = ap.parse_args(argv)
    if args.scaling_worker:
        return scaling_worker(json.loads(args.scaling_worker))
    if args.platform == "cuda":
        if not torch.cuda.is_available():
            print("bench_torch: no CUDA device visible; nothing was measured",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    # Every run adapts its bands from scratch.
    os.environ["BIOINFO1_BAND_CACHE"] = "0"
    result = run_measurement(TINY if args.tiny else FULL, device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
