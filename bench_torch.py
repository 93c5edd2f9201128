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

Times are host-clock seconds around work that ends synchronised with the
device, or CUDA events for single kernels.  A measurement that raises ends
the run with a non-zero exit.  There is no CPU fallback: without
``--platform cpu`` a missing card is an error.  ``--platform cpu --tiny``
runs every measurement at toy sizes with the kernels' plain versions (K6's
launch excepted); its numbers say nothing about the card and are tagged
``"platform": "cpu"``.  The reference binary is not measured here, so
every ``*_baseline`` entry is null.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
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

K, W, F = 15, 5, 0.001
SEED = 20250817
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
             fill_w=128, fill_b=4, warm_passes=1, timed_passes=1, tiny=True)


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
    on_card = device.type == "cuda"
    return {
        "metric": "reads_per_s_4kb_ecoli", "value": round(ours, 2),
        "unit": "reads/s", "vs_baseline": None,
        "extra": {
            "mapped": mapped, "n_reads": sizes.n_reads,
            "index_build_s": round(t_index, 2), "gcups": round(gcups, 3),
            "band_vs_full_parity": parity,
            "product_mixed_reads_per_s": round(mixed_rps, 2),
            "product_mixed_bases_per_s": round(mixed_bps),
            "cigar_reads_per_s": round(cigar_rps, 2),
            "indel_reads_per_s": round(indel["indel_reads_per_s"], 2),
            "indel_vs_baseline": None,
            "indel_counters": indel["indel_counters"],
            "cigar_indel_reads_per_s":
                round(indel["cigar_indel_reads_per_s"], 2),
            "cigar_indel_pct_of_score": indel["cigar_indel_pct_of_score"],
            "cigar_indel_counters": indel["cigar_indel_counters"],
            "repeat_reads_per_s": round(repeat["repeat_reads_per_s"], 2),
            "repeat_cigar_reads_per_s":
                round(repeat["repeat_cigar_reads_per_s"], 2),
            "repeat_vs_baseline": None,
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
            "baseline_reads_per_s": None, "baseline_omp_reads_per_s": None,
        }}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="toy sizes (for a CPU run)")
    args = ap.parse_args(argv)
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
