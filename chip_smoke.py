"""Chip smoke test of the PyTorch + CUDA port (bioinfo1_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile-map | --lpt-trial]

Phases, in this order (each prints one JSON line; any mismatch fails the
run):
  0. device: card, torch and CUDA versions, nvidia-smi name and power
     limit; builds the CUDA kernels from bioinfo1_tpu_torch/csrc.
  1. every kernel against its plain PyTorch version on the card, exact
     integer equality, with both times and the work the function needs
     (matrix cells, pairs, steps, bytes; the lanes a kernel sweeps beside
     them): K1 LIS chain, K2 banded score, K3 full score, K4
     banded score + parents (parents compared on the cells they are
     defined on, ops/band.parent_cells), K5 traceback walk (on each K4
     parent tensor; K4 and K5 also at a band that covers the whole
     matrix), K6 int32 probe.  K2 and K4 run on every dispatch path of
     ops/band.band_plan, each row naming its path and lanes per thread:
     one warp per read (W = 128, 256; also with more reads than fill
     whole CTAs), several warps per read (W = 512, 1024, 4096) and the
     scratch kernel (W = 19968), all three modes and both dash_free
     settings on each.
  2. the CLI's default score-only path at E. coli scale: a 4,641,652 bp
     synthetic genome (direct-address index on the card) and 2,048
     ONT-profile reads (2/4/8 kb plus 10% at 200-500 bp) through
     bioinfo1_tpu_torch.cli.main; K1, K2 and K3 must have launched, the
     realign pass must have run and >= 90% of reads >= 2 kb must map.
  2c. the CLI's -c path on the same genome: -c (global) on all 2,048
     reads, -c -a local and -c -a semiGlobal on the first 512; in each run
     K1, K4 and K5 must have launched, every PAF line must carry a cg:Z:
     CIGAR and >= 90% of reads >= 2 kb must map; the global run must have
     taken the parents realign pass.
  2s. the staged host path through the CLI: -c -g 1 and -c -a local -g 1
     (no exactness certificate) on the first 256 reads, and --bug-compat
     on a FASTA copy of the first 512 (FASTA match nesting, score-only);
     t_host_s > 0 and K1, K4 and K5 (K3 in the FASTA run) launched.
  2r. bench_torch.measure_repeat() at full size (a 4,641,652 bp
     repeat-structured genome, 1,026 + 1,026 reads, score-only and -c)
     with its reads/s and counters, then bench_torch.measure_sol(): K6's
     int32 rate, K2's fill rate, the int32 instructions per cell and the
     SM clock.
  3. with BIOINFO1_PLATFORM=cpu in subprocesses: the first 96 reads
     score-only and under -c, the first 32 under -c -a local, and 32
     reads of at most 4.5 kb under -c -g 1 and (as FASTA) --bug-compat;
     their PAF lines must equal the GPU runs' byte for byte.
  4. only with --profile-map: the map stage alone on phase 2's inputs,
     score-only and -c, and on 32 reads of 50 kb score-only, fresh and
     with adapted bands, without and then under torch.profiler (device
     busy time and share, device time and launches by kernel, the
     mapper's counters of each pass).

  With --lpt-trial phase 0 builds K2 / K4 with every lanes-per-thread
  variant, phase 1t times them at the phase-1 pairs (the table behind
  ops/band.WARP_LPT and WARPS_LPT), and the run ends there.

The genome and reads come from bioinfo1_tpu_torch/utils/simulate.py.

The second-to-last line is the kernel table as JSON: per kernel its
launches on its path, its time, the plain version's, and its bound - the
larger of its bytes over the card's memory rate and the int32 operations
the function needs (NEEDED_OPS per unit, times this run's cells inside
the matrix) over the card's issue rate.  What the kernel's own SASS loop
issues per unit stands beside it (int_ops_per_unit, issued_over_needed)
and moves no bound.  The last line is {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when no CUDA device is visible.
Scratch files go to build/chip_smoke/, and every JSON line printed is also
appended to build/chip_smoke/smoke.jsonl (the whole record, where a
terminal keeps only the end of the output).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import bench_torch
from bioinfo1_tpu_torch.utils import simulate as sim

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
LOG = os.path.join(WORK, "smoke.jsonl")    # this run's JSON lines
GENOME_LEN = 4_641_652
GENOME_SEED = 20250817
N_READS = 2048
N_CIGAR_MODE_READS = 512          # -c -a local / semiGlobal (phase 2c)
N_CPU_READS = 96
N_CPU_LOCAL_READS = 32            # -c -a local (phase 3)
N_STAGED_READS = 256              # -c -g 1 (phase 2s)
N_STAGED_FASTA_READS = 512        # --bug-compat on FASTA (phase 2s)
N_CPU_STAGED_READS = 32           # staged runs on the CPU (phase 3)
CPU_STAGED_MAX_LEN = 4500

# Card peaks the bounds are stated against (NVIDIA's H100 SXM data sheet):
# 3.35 TB/s of HBM; 67 TFLOP/s of float32 outside the tensor cores is one
# FMA per lane and clock, i.e. 33.5e12 instruction-lanes per second, the
# rate at which the same lanes issue int32 instructions.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_PER_S = 67e12 / 2

# Int32 operations the FUNCTION needs per unit of work, whatever kernel
# computes it; the bounds use these, so a leaner kernel leaves them where
# they are.  Borders, the '-' rule, the local clamp, addressing and loads are
# left out: a redesign may shed or amortise them.
#   pair (K1): is j a predecessor of i?  r_i - r_j - 1 and f_i - f_j - 1 (two
#     subtracts), each held under 4999 by one unsigned compare (two; the
#     second takes the first's predicate), one max of the packed state: 5.
#   cell (K2, K3): compare the two bases, select match / mismatch, three
#     adds (diagonal, up, left), two maxes: 7 (bench_torch).
#   cell with parents (K4): the same 7, two compares and two selects for
#     which of M, I, D gave the best (M > I > D), one shift-add of the code
#     into the lane's byte: 12.
#   step (K5): a dependent byte load per step; no instruction bound.
#   trip (K6): the adds and maxes its source writes, 2 * ILP * UNROLL.
NEEDED_OPS = {
    "lis_chain": 5,
    "band_score": bench_torch.NEEDED_OPS_PER_CELL,
    "full_score": bench_torch.NEEDED_OPS_PER_CELL,
    "band_parents": bench_torch.NEEDED_OPS_PER_CELL + 5,
    "walk_parents": 0,
    "int32_probe": bench_torch.probe.source_ops(1, 1),
}

KERNELS = {
    "lis_chain": ("bioinfo1_tpu_torch/csrc/lis_chain.cu",
                  "bioinfo1_tpu/ops/pallas_chain.py:57"),
    "band_score": ("bioinfo1_tpu_torch/csrc/band_score.cu",
                   "bioinfo1_tpu/ops/pallas_band.py:56"),
    "full_score": ("bioinfo1_tpu_torch/csrc/full_score.cu",
                   "bioinfo1_tpu/ops/pallas_align.py:45"),
    "band_parents": ("bioinfo1_tpu_torch/csrc/band_score.cu",
                     "bioinfo1_tpu/ops/pallas_band.py:56"),
    "walk_parents": ("bioinfo1_tpu_torch/csrc/walk_parents.cu",
                     "bioinfo1_tpu/ops/trace.py:160"),
    "int32_probe": ("bioinfo1_tpu_torch/csrc/int32_probe.cu",
                    "bench.py:240"),
}


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    os.makedirs(WORK, exist_ok=True)
    with open(LOG, "a") as fh:
        fh.write(line + "\n")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> int:
    """Largest difference over a dataclass's tensor fields, or of two
    tensors; a field that is None in both is skipped."""
    if isinstance(got, torch.Tensor):
        return int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
    return max(max_abs_err(getattr(got, f), getattr(want, f))
               for f in got.__dataclass_fields__
               if getattr(want, f) is not None)


def compare(name: str, kernel, plain, reps: int = 3, err_fn=max_abs_err,
            keep: bool = False):
    """Run kernel and plain version on the same inputs; exact equality.
    With ``keep`` also returns the kernel's output."""
    got = kernel()                              # first call: warm-up + check
    kernel()        # second: the allocator's cache now holds the outputs
    torch.cuda.synchronize()
    ms = cuda_ms(kernel, reps)
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = err_fn(got, want)
    check(err == 0, f"{name}: kernel differs from its plain version "
                    f"(max abs err {err})")
    row = {"call": name, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    return (row, got) if keep else row


def parents_err(q_lens, t_lens, m_eff):
    """max_abs_err of two banded outputs with parents: score and goal
    cells everywhere, parents on the cells they are defined on."""
    from bioinfo1_tpu_torch.ops import band as bd

    def err(got, want):
        cells = [bd.parent_cells(x.parents, q_lens, t_lens, m_eff)
                 for x in (got, want)]
        return max(max_abs_err(got.score, want.score),
                   max_abs_err(got.goal_i, want.goal_i),
                   max_abs_err(got.goal_j, want.goal_j),
                   max_abs_err(*cells))
    return err


# ---- phase 1 inputs -------------------------------------------------------

def chain_inputs(rng, R: int, N: int, dev):
    """Match rows of sorted query positions with repeat copies 4999 and
    5000 apart (both sides of the predecessor window), random jumps, an
    empty row and a full row."""
    f = np.zeros((R, N), np.int32)
    r = np.zeros((R, N), np.int32)
    cnt = rng.integers(0, N + 1, R).astype(np.int32)
    cnt[0], cnt[1] = 0, N
    span = max(4 * N, 20000)
    for b in range(R):
        n = int(cnt[b])
        fs = np.sort(rng.integers(1, span, n)).astype(np.int32)
        rs = (fs + rng.integers(0, 3, n).astype(np.int32)
              * (4999 + (b & 1)) + rng.integers(-30, 30, n).astype(np.int32))
        jump = rng.random(n) < 0.05
        rs[jump] = rng.integers(1, 4 * span, int(jump.sum()))
        f[b, :n] = fs
        r[b, :n] = np.maximum(rs, 1)
    # Row 2: predecessors exactly 4999 apart (chain), row 3: 5000 (none).
    for b, step in ((2, 4999), (3, 5000)):
        n = min(N, 64)
        cnt[b] = n
        f[b, :n] = 1 + step * np.arange(n)
        r[b, :n] = 1 + step * np.arange(n)
    t = [torch.from_numpy(x).to(dev) for x in (f, r, cnt)]
    return t


def pair_inputs(rng, B: int, n: int, m: int, dev, dash_rows: int = 8):
    """ONT-like query/target pairs (indels drift the path), lengths spread
    over the widths, a few rows with '-' bytes and targets past n + W."""
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(n // 4, n + 1))
        tgt = sim.random_genome(min(m, int(ln * 1.3) + 8), rng)
        qry = sim.mutate_read(tgt[:ln], rng)[:n]
        if b % 7 == 0:
            tgt = sim.random_genome(m, rng)               # long target
        qa[b, :len(qry)], ql[b] = qry, len(qry)
        ta[b, :len(tgt)], tl[b] = tgt, len(tgt)
    for b in range(min(dash_rows, B)):
        qa[b, rng.integers(0, max(ql[b], 1), 3)] = ord("-")
        ta[b, rng.integers(0, max(tl[b], 1), 3)] = ord("-")
    ql[-1] = tl[-1] = 0
    return [torch.from_numpy(x).to(dev) for x in (qa, ql, ta, tl)]


def band_work(q, ql, t, tl, W: int, want_parents: bool) -> dict:
    """What a banded call needs: the cells of each pair's matrix that lie
    in the band (``work``), and the bytes it must move - both inputs and
    the lengths read once, the three outputs written once and, with
    parents, two bits per cell.  ``swept`` is what the kernel's layout
    visits instead: every diagonal up to each read's last, W lanes each,
    corners off the matrix included."""
    from bioinfo1_tpu_torch.ops import band as bd
    _, _, m_eff, n_steps = bd.band_shapes(q.shape[1], t.shape[1], W)
    tl_eff = tl.long().clamp(max=m_eff)
    d_stop = (ql.long() + tl_eff).clamp(max=n_steps + 1)
    cells = bench_torch.band_cells(ql, tl_eff, W)
    nbytes = q.numel() + t.numel() + 8 * q.shape[0] + 12 * q.shape[0]
    if want_parents:
        nbytes += (cells + 3) // 4
    return {"work": cells, "unit": "cells", "bytes": nbytes,
            "swept": int((d_stop - 1).clamp(min=0).sum()) * W}


def phase_kernels(dev) -> dict:
    from bioinfo1_tpu_torch.ops import align as al
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import chain as ch
    from bioinfo1_tpu_torch.ops import probe
    from bioinfo1_tpu_torch.ops import trace as tr
    rng = np.random.default_rng(1)
    rows = {name: [] for name in KERNELS}

    for R, N in ((512, 1536), (64, 16384), (64, 24576)):
        f, r, cnt = chain_inputs(rng, R, N, dev)
        row = compare(f"lis_chain R={R} N={N}",
                      lambda: ch.lis_chain(f, r, cnt),
                      lambda: ch.lis_chain_plain(f, r, cnt),
                      reps=3 if N <= 1536 else 1)
        row["smem"] = 12 * N <= build.SMEM_LIMIT
        c = cnt.long()
        row.update(work=int((c * (c - 1) // 2).sum()), unit="pairs",
                   bytes=8 * R * N + 4 * R + 20 * R)
        rows["lis_chain"].append(row)

    scoring = (1, -1, -1)
    q, ql, t, tl = pair_inputs(rng, 256, 4096, 6144, dev)

    def plan_of(B, W, want_parents):
        """Which kernel of csrc/band_score.cu the row ran on."""
        plan = bd.band_plan(W, B, want_parents)
        return {"path": plan.path, "lpt": plan.lpt,
                "reads_per_cta": plan.reads_per_cta}

    def band_row(pairs, W, mode, dash_free, reps):
        qq, qql, tt, ttl = pairs
        B = qq.shape[0]
        row = compare(
            f"band W={W} B={B} n={qq.shape[1]} mode={mode} "
            f"dash_free={dash_free}",
            lambda: bd.align_scores_banded(qq, qql, tt, ttl, *scoring,
                                           band=W, mode=mode,
                                           dash_free=dash_free),
            lambda: bd.align_scores_banded_plain(
                qq, qql, tt, ttl, *scoring, band=W, mode=mode,
                dash_free=dash_free), reps=reps)
        row.update(plan_of(B, W, False))
        row.update(band_work(qq, qql, tt, ttl, W, False))
        rows["band_score"].append(row)

    def first(B):
        return [x[:B].contiguous() for x in (q, ql, t, tl)]

    # The fused step's shape on the one-warp path, every mode and variant
    # (the first row is the kernel table's).
    for mode in (0, 1, 2):
        for dash_free in (True, False):
            band_row((q, ql, t, tl), 256, mode, dash_free, 3)
    # Every dispatch path at the same pairs: one warp per read (W = 128),
    # several warps (W = 512 ... 4096), the scratch kernel (W = 19968).
    for B, W in ((256, 128), (256, 512), (256, 1024), (256, 4096),
                 (32, 19968)):
        band_row(first(B), W, 0, True, 3 if W <= 1024 else 1)
    # Small pairs: every mode and variant on the several-warps and the
    # scratch path, and a B that is no multiple of the reads per CTA.
    small = pair_inputs(rng, 12, 600, 900, dev)
    many = pair_inputs(rng, 531, 512, 768, dev)
    check(bd.band_plan(128, 531, False).reads_per_cta > 1
          and 531 % bd.band_plan(128, 531, False).reads_per_cta,
          "531 reads fill whole CTAs: the ragged last CTA is not driven")
    for mode in (0, 1, 2):
        for dash_free in (True, False):
            for W in (512, 19968):
                band_row(small, W, mode, dash_free, 1)
        band_row(many, 128, mode, False, 1)

    def parents_and_walk(qq, qql, tt, ttl, W, mode, dash_free, reps):
        """K4 on the pairs, then K5 against the plain walk on K4's
        parents."""
        B = qq.shape[0]
        m_eff = bd.band_shapes(qq.shape[1], tt.shape[1], W)[2]
        row, out = compare(
            f"band+parents W={W} B={B} n={qq.shape[1]} mode={mode} "
            f"dash_free={dash_free}",
            lambda: bd.align_scores_banded(qq, qql, tt, ttl, *scoring,
                                           band=W, mode=mode,
                                           dash_free=dash_free,
                                           want_parents=True),
            lambda: bd.align_scores_banded_plain(
                qq, qql, tt, ttl, *scoring, band=W, mode=mode,
                dash_free=dash_free, want_parents=True),
            reps=reps, err_fn=parents_err(qql, ttl, m_eff), keep=True)
        row["parent_bytes"] = out.parents.numel()
        row.update(plan_of(B, W, True))
        row.update(band_work(qq, qql, tt, ttl, W, True))
        rows["band_parents"].append(row)
        walk_args = (out.parents, out.goal_i, out.goal_j, out.score, qq, tt,
                     *scoring, mode)
        wrow, codes = compare(
            f"walk W={W} B={B} n={qq.shape[1]} mode={mode}",
            lambda: tr.walk_parents(*walk_args),
            lambda: tr.walk_parents_plain(*walk_args), reps=3, keep=True)
        # One dependent parent-byte load per step: the bytes the walk needs
        # are its steps, its goals and the codes it writes.
        steps = torch.from_numpy(tr.unpack_codes(codes.cpu().numpy())
                                 != tr.OP_DONE).sum(dim=0)
        wrow.update(work=int(steps.sum()), unit="steps",
                    chain_steps=int(steps.max()),
                    bytes=int(steps.sum()) + 12 * B + codes.numel())
        rows["walk_parents"].append(wrow)
        return out.score

    # K4 at the fused -c shape in each mode, then the other widths of the
    # register paths (the last is a wide realign call).
    for B, W, mode in ((256, 256, 0), (256, 256, 1), (256, 256, 2),
                       (256, 128, 0), (256, 512, 0), (128, 1024, 0),
                       (32, 4096, 0)):
        parents_and_walk(*first(B), W, mode, True, 3 if W <= 256 else 1)
    del q, ql, t, tl
    # Small pairs: every mode and variant on the several-warps and the
    # scratch path; the ragged last CTA of the one-warp path.
    for mode in (0, 1, 2):
        for dash_free in (True, False):
            for W in (512, 19968):
                parents_and_walk(*small, W, mode, dash_free, 1)
        parents_and_walk(*many, 128, mode, False, 1)
    # The staged path's -c shape: a band that covers the whole matrix (the
    # full DP), the general variant ('-' bytes present), every mode.
    q, ql, t, tl = pair_inputs(rng, 32, 2048, 2304, dev)
    w_whole = -(-max(int(ql.max()), int(tl.max()) + 2) // 128) * 128
    for mode in (0, 1, 2):
        score = parents_and_walk(q, ql, t, tl, w_whole, mode, False, 1)
        check(bool(bd.certify(score, q, ql, t, tl, *scoring, w_whole,
                              strict=True, mode=mode).all()),
              f"mode {mode}: the whole-matrix band does not certify")

    q, ql, t, tl = pair_inputs(rng, 64, 512, 1024, dev)
    for mode in (0, 1, 2):
        row = compare(
            f"full n=512 m=1024 mode={mode}",
            lambda: al.align_scores(q, ql, t, tl, mode, *scoring),
            lambda: al.align_scores_plain(q, ql, t, tl, mode, *scoring),
            reps=5)
        diags = (ql.long() + tl.long() - 1).clamp(min=0)
        row.update(work=int((ql.long() * tl.long()).sum()), unit="cells",
                   bytes=q.numel() + t.numel() + 20 * q.shape[0],
                   swept=int(diags.sum()) * (q.shape[1] + 1))
        rows["full_score"].append(row)

    x = torch.from_numpy(rng.integers(-1000, 1000, (256, 1024))
                         .astype(np.int32)).to(dev)
    row = compare("int32_probe (256, 1024) n_iter=100",
                  lambda: probe.int32_probe(x, 100),
                  lambda: probe.int32_probe_plain(x, 100), reps=5)
    row.update(work=x.numel() * 100, unit="trips", bytes=8 * x.numel())
    rows["int32_probe"].append(row)
    return rows


def phase_lpt_trial(dev) -> dict:
    """K2 and K4 times at the phase-1 pairs for every choice of lanes per
    thread (LPT) on both register paths, global / local / semiGlobal,
    dash_free: the measurement behind ops/band.WARP_LPT and WARPS_LPT.
    Needs the trial instantiations (BIOINFO1_BAND_LPT_TRIAL, set by
    --lpt-trial before the build) and overrides the plan's tables for the
    time of each row; no result is compared here (phase 1 does that for
    the plan that is kept)."""
    from bioinfo1_tpu_torch.ops import band as bd
    rng = np.random.default_rng(1)
    q, ql, t, tl = pair_inputs(rng, 768, 4096, 6144, dev)
    kept = bd.WARP_LPT, bd.WARPS_LPT
    rows = []

    def ms(pairs, W, mode, parents, reps):
        def run():
            return bd.align_scores_banded(*pairs, 1, -1, -1, band=W,
                                          mode=mode, dash_free=True,
                                          want_parents=parents)
        run(), run()
        torch.cuda.synchronize()
        return cuda_ms(run, reps)

    try:
        for W, shapes, plans in (
                (256, ((256, False), (256, True), (768, False), (768, True)),
                 (({256: 8}, 8), ({}, 8), ({}, 4), ({}, 16))),
                (512, ((256, False), (256, True)),
                 (({}, 8), ({}, 4), ({}, 16), ({512: 16}, 8))),
                (1024, ((256, False), (256, True)),
                 (({}, 8), ({}, 4), ({}, 16))),
                (4096, ((256, False), (32, True)),
                 (({}, 8), ({}, 4), ({}, 16)))):
            for warp_lpt, warps_lpt in plans:
                bd.WARP_LPT, bd.WARPS_LPT = warp_lpt, warps_lpt
                for B, parents in shapes:
                    pairs = [x[:B].contiguous() for x in (q, ql, t, tl)]
                    plan = bd.band_plan(W, B, parents)
                    rows.append({
                        "W": W, "B": B, "parents": parents,
                        "path": plan.path, "lpt": plan.lpt,
                        "threads_per_read": plan.threads_per_read,
                        "ms_mode012": [ms(pairs, W, mode, parents,
                                          3 if W <= 1024 else 1)
                                       for mode in (0, 1, 2)]})
    finally:
        bd.WARP_LPT, bd.WARPS_LPT = kept
    return {"phase": "1t", "rows": rows}


def issued_per_unit(listing: str) -> dict:
    """Integer instructions each kernel issues per unit of work, counted in
    its own SASS: the integer instructions of its largest innermost loop,
    per pair for K1, per swept lane for K3, per trip (its add and max
    instructions) for K6.  For K2 and K4 the kernel that serves the
    table's row (W = 256, global, dash_free): the integer instructions of
    its interior pair loop over the 2 * LPT cells of a trip.  Reported
    beside NEEDED_OPS; no bound uses it."""
    import sass_census as sass
    from bioinfo1_tpu_torch.ops import band as bd

    def ints(needle):
        return sass.cell_loops(listing, needle)[0]["by_kind"].get("int", 0)

    def band(parents):
        plan = bd.band_plan(256, 256, parents)
        needle = sass.band_reg_needle(parents, True, 0, plan.lpt,
                                      plan.path == "warps")
        return sass.band_interior_loop(listing, needle,
                                       plan.lpt)["int_per_cell"]

    return {"lis_chain": ints("lis_chain_kernel"),
            "band_score": band(False),
            "band_parents": band(True),
            "full_score": ints("full_score_kernel"),
            "walk_parents": 0,
            "int32_probe":
                bench_torch.probe_census(listing)["issued_per_trip"]}


def bound(row: dict, ops: float) -> tuple:
    """(bound_ms, bound_by) of one phase-1 row: the larger of its bytes
    over the card's memory rate and ``ops`` int32 operations per unit of
    its work over the card's issue rate."""
    t_bytes = row["bytes"] / PEAK_BYTES_PER_S
    t_ops = row["work"] * ops / PEAK_INT32_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---- phase 2 / 3 ----------------------------------------------------------

def write_inputs():
    os.makedirs(WORK, exist_ok=True)
    genome = sim.random_genome(GENOME_LEN,
                               np.random.default_rng(GENOME_SEED))
    rng = np.random.default_rng(GENOME_SEED + 1)
    n_short = N_READS // 10
    lengths = [(2000, 4000, 8000)[i % 3] for i in range(N_READS - n_short)]
    lengths += [int(x) for x in rng.integers(200, 501, n_short)]
    order = rng.permutation(len(lengths))
    recs = sim.simulate_reads(genome, [lengths[i] for i in order], rng)
    ref = os.path.join(WORK, "ref.fa")
    g = genome.tobytes().decode("latin1")
    with open(ref, "w") as fh:
        fh.write(">ecoli_like\n")
        for i in range(0, len(g), 80):
            fh.write(g[i:i + 80] + "\n")

    def write_fq(path, rs):
        with open(path, "w") as fh:
            for name, s in rs:
                fh.write(f"@{name}\n{s}\n+\n{'5' * len(s)}\n")

    def write_fa(path, rs):
        with open(path, "w") as fh:
            for name, s in rs:
                fh.write(f">{name}\n{s}\n")
    paths = {}
    for n in (N_READS, N_CIGAR_MODE_READS, N_STAGED_READS, N_CPU_READS,
              N_CPU_LOCAL_READS):
        paths[n] = os.path.join(WORK, f"reads{n}.fq")
        write_fq(paths[n], recs[:n])
    paths["fa"] = os.path.join(WORK, f"reads{N_STAGED_FASTA_READS}.fa")
    write_fa(paths["fa"], recs[:N_STAGED_FASTA_READS])
    # The staged runs' CPU subset: whole-matrix DPs in plain PyTorch are
    # slow, so the first reads of at most CPU_STAGED_MAX_LEN bases.
    short = [r for r in recs[:N_STAGED_READS]
             if len(r[1]) <= CPU_STAGED_MAX_LEN][:N_CPU_STAGED_READS]
    paths["cpu_staged_fq"] = os.path.join(WORK, "reads_cpu_staged.fq")
    paths["cpu_staged_fa"] = os.path.join(WORK, "reads_cpu_staged.fa")
    write_fq(paths["cpu_staged_fq"], short)
    write_fa(paths["cpu_staged_fa"], short)
    return ref, paths, recs, g, short


def parse_profile(err: str) -> dict:
    """Stage totals and the two JSON counter lines of --profile."""
    stages, jsons = {}, []
    for line in err.splitlines():
        parts = line.split()
        if line.startswith("{"):
            jsons.append(json.loads(line))
        elif len(parts) == 4 and parts[0] != "stage":
            stages[parts[0]] = float(parts[1])
    return {"stages_s": stages, "throughput": jsons[0], "mapper": jsons[1]}


def launch_counters() -> dict:
    """Kernel name -> (wrapper, attribute) holding its launch count."""
    from bioinfo1_tpu_torch.ops import align as al
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.ops import chain as ch
    from bioinfo1_tpu_torch.ops import probe
    from bioinfo1_tpu_torch.ops import trace as tr
    return {"int32_probe": (probe.int32_probe, "launches"),
            "lis_chain": (ch.lis_chain, "launches"),
            "band_score": (bd.align_scores_banded, "launches"),
            "full_score": (al.align_scores, "launches"),
            "band_parents": (bd.align_scores_banded, "parent_launches"),
            "walk_parents": (tr.walk_parents, "launches")}


def reset_launches() -> dict:
    counters = launch_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    return counters


def run_cli(ref, reads, recs, flags, out_name: str, must_launch,
            min_frac: float = 0.9) -> tuple:
    """One GPU CLI run with --profile, the kernel counts set to 0 just
    before it and read just after; checks rc 0, the kernels in
    ``must_launch`` and that >= ``min_frac`` of reads >= 2 kb mapped."""
    from bioinfo1_tpu_torch import cli
    out = os.path.join(WORK, out_name)
    err = io.StringIO()
    counters = reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(flags + [ref, reads, "-o", out, "--profile"], stderr=err)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(w, a) for k, (w, a) in counters.items()}
    sys.stderr.write(err.getvalue())
    check(rc == 0, f"cli.main {flags} returned {rc}")
    prof = parse_profile(err.getvalue())
    for k in must_launch:
        check(launches[k] >= 1, f"kernel {k} never launched in {flags}")
    with open(out) as fh:
        lines = fh.read().splitlines()
    names = {line.split("\t")[0] for line in lines}
    long_reads = [n for n, s in recs if len(s) >= 2000]
    frac = sum(n in names for n in long_reads) / len(long_reads)
    check(frac >= min_frac,
          f"{flags}: only {frac:.3f} of reads >= 2 kb mapped")
    map_s = prof["stages_s"]["map"]
    return {"phase": None, "flags": flags, "reads": len(recs), "rc": rc,
            "wall_s": wall,
            "map_s": map_s, "reads_per_s_map": len(recs) / map_s,
            "reads_per_s_wall": len(recs) / wall,
            "index_build_s": prof["stages_s"]["index_build"],
            "index_upload_s": prof["stages_s"]["index_upload"],
            "mapped_frac_ge_2kb": frac, "paf_lines": len(lines),
            "launches": launches, "stages_s": prof["stages_s"],
            "mapper": prof["mapper"]}, lines


def phase_pipeline(ref, reads, recs) -> tuple:
    row, lines = run_cli(ref, reads, recs, [], "gpu.paf",
                         ("lis_chain", "band_score", "full_score"))
    check(row["mapper"]["realign_batches"] >= 1, "realign pass never ran")
    row["phase"] = 2
    return row, lines


def phase_cigar(ref, paths, recs) -> tuple:
    """-c in the three modes; returns the phase row and the PAF lines of
    each run."""
    runs, lines = [], {}
    for flags, n in ((["-c"], N_READS),
                     (["-c", "-a", "local"], N_CIGAR_MODE_READS),
                     (["-c", "-a", "semiGlobal"], N_CIGAR_MODE_READS)):
        name = "_".join(f.strip("-") for f in flags)
        row, out = run_cli(ref, paths[n], recs[:n], flags,
                           f"gpu_{name}.paf",
                           ("lis_chain", "band_parents", "walk_parents"))
        check(all("\tcg:Z:" in line for line in out),
              f"{flags}: a PAF line without cg:Z:")
        del row["phase"]
        runs.append(row)
        lines[name] = out
    check(runs[0]["mapper"]["realign_batches"] >= 1,
          "the -c parents realign pass never ran")
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    return {"phase": "2c", "runs": runs, "launches": launches}, lines


def phase_staged(ref, paths, recs) -> tuple:
    """The staged host path through the CLI: -c where no exactness
    certificate exists (every read ends on the host route: K4 at a band
    that covers the whole matrix, K5), and FASTA match nesting (the whole
    run is staged; score-only, so K3).  With nesting a reverse-strand
    lookup needs a forward-index hit of the same minimizer, so fewer reads
    may map."""
    runs, lines = [], {}
    fq, fa = paths[N_STAGED_READS], paths["fa"]
    for key, flags, reads, n, kernels, min_frac in (
            ("c_g1", ["-c", "-g", "1"], fq, N_STAGED_READS,
             ("lis_chain", "band_parents", "walk_parents"), 0.9),
            ("c_a_local_g1", ["-c", "-a", "local", "-g", "1"], fq,
             N_STAGED_READS, ("lis_chain", "band_parents", "walk_parents"),
             0.9),
            ("bug_compat_fa", ["--bug-compat"], fa, N_STAGED_FASTA_READS,
             ("lis_chain", "full_score"), 0.3)):
        row, out = run_cli(ref, reads, recs[:n], flags, f"gpu_{key}.paf",
                           kernels, min_frac)
        m = row["mapper"]
        check(m["t_host_s"] > 0, f"{flags}: the host route never ran")
        if "-c" in flags:
            check(all("\tcg:Z:" in line for line in out),
                  f"{flags}: a PAF line without cg:Z:")
            # Global mode with gap >= 0 has no finite certifying band, so
            # all but the reads band 256 already covers whole fall back;
            # in local mode the realign pass may reach the whole matrix.
            want = m["mapped"] * 9 // 10 if key == "c_g1" else 1
            check(m["host_fallbacks"] >= want,
                  f"{flags}: only {m['host_fallbacks']} reads fell back to "
                  "the host route")
        else:
            check(m["t_fused_s"] == 0, f"{flags}: a fused batch ran")
        del row["phase"]
        runs.append(row)
        lines[key] = out
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    return {"phase": "2s", "runs": runs, "launches": launches}, lines


def phase_repeat_and_roofline(dev) -> dict:
    """bench_torch's repeat-genome measurement at full size (the budget
    ladder, bucket boosts, repeat-dense chains and whatever reaches the
    host route), then its roofline; kernel counts around both."""
    counters = reset_launches()
    t0 = time.perf_counter()
    repeat = bench_torch.measure_repeat(device=dev)
    repeat_s = time.perf_counter() - t0
    launches = {k: getattr(w, a) for k, (w, a) in counters.items()}
    for k in ("lis_chain", "band_score", "band_parents", "walk_parents"):
        check(launches[k] >= 1, f"kernel {k} never launched on the repeat "
                                "genome")
    for k in ("repeat_reads_per_s", "repeat_cigar_reads_per_s"):
        check(repeat[k] > 0, f"{k} is {repeat[k]}")
    torch.cuda.empty_cache()
    counters = reset_launches()
    sol = bench_torch.measure_sol(device=dev)
    probe_launches = counters["int32_probe"][0].launches
    check(probe_launches >= 1, "the int32 probe never launched")
    for k in ("int32_tops", "int32_issued_tops", "band_cells_per_s_g",
              "gcups_sol_pct"):
        check(sol[k] and sol[k] > 0, f"sol.{k} is {sol[k]}")
    check(sol["int32_issued_tops"] * 1e12 <= PEAK_INT32_PER_S,
          f"the probe reads {sol['int32_issued_tops']} T instructions/s, "
          "over the card's issue rate: something was folded or miscounted")
    for k in ("gcups_sol_pct", "gcups_needed_pct"):
        check(sol[k] <= 100, f"K2 reads over 100% of its roofline: {k}")
    launches["int32_probe"] = probe_launches
    return {"phase": "2r", "repeat": repeat, "repeat_wall_s": repeat_s,
            "sol": sol, "launches": launches}


def phase_cpu_crosscheck(ref, paths, recs, gpu_lines, short) -> dict:
    """The CPU runs of the port (plain versions) in parallel subprocesses,
    each held byte for byte to the GPU run's lines of the same reads."""
    env = dict(os.environ, BIOINFO1_PLATFORM="cpu", BIOINFO1_BAND_CACHE="0",
               OMP_NUM_THREADS="2")
    jobs = []
    staged = {name for name, _ in short}
    for key, flags, reads, names in (
            ("score", [], paths[N_CPU_READS], None),
            ("c", ["-c"], paths[N_CPU_READS], None),
            ("c_a_local", ["-c", "-a", "local"], paths[N_CPU_LOCAL_READS],
             None),
            ("c_g1", ["-c", "-g", "1"], paths["cpu_staged_fq"], staged),
            ("bug_compat_fa", ["--bug-compat"], paths["cpu_staged_fa"],
             staged)):
        if names is None:
            n = N_CPU_LOCAL_READS if key == "c_a_local" else N_CPU_READS
            names = {name for name, _ in recs[:n]}
        out = os.path.join(WORK, f"cpu_{key}.paf")
        proc = subprocess.Popen(
            [sys.executable, "-m", "bioinfo1_tpu_torch.cli", *flags, ref,
             reads, "-o", out], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((key, flags, names, out, proc))
    t0 = time.perf_counter()
    res = {"phase": 3, "runs": []}
    try:
        for key, flags, names, out, proc in jobs:
            _, err = proc.communicate(timeout=900)
            dt = time.perf_counter() - t0
            check(proc.returncode == 0, f"CPU run {flags} failed "
                  f"(rc {proc.returncode}): {err[-2000:]}")
            with open(out) as fh:
                cpu_lines = fh.read().splitlines()
            gpu_same = [line for line in gpu_lines[key]
                        if line.split("\t")[0] in names]
            check(cpu_lines == gpu_same and cpu_lines,
                  f"CPU and GPU PAF differ for {len(names)} reads, {flags}")
            res["runs"].append({"flags": flags, "reads": len(names),
                                "paf_lines": len(cpu_lines),
                                "byte_identical": True,
                                "cpu_wall_s_since_start": dt})
    finally:
        for *_x, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return res


def device_time(prof):
    """(busy seconds, top device events) of a torch.profiler run: busy is
    the union of the device intervals; top lists the 12 names with the most
    device time as [name, launches, ms]."""
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in ev):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name: dict = {}
    for e in ev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return busy_us / 1e6, [[k, n, us / 1e3] for k, (n, us) in top]


def phase_profile(genome: str, recs) -> dict:
    """The map stage alone, with the index resident, for each cell
    (score-only, and -c global): a fresh mapper's first pass (band
    adaptation from scratch, as one CLI run) and its second pass (bands
    adapted).  Mapper A runs both passes without the profiler (wall
    times); mapper B runs them under torch.profiler, and each of its passes
    reports its own wall time, device busy time and busy share."""
    from bioinfo1_tpu_torch.pipeline.mapper import MapperConfig
    # The bench's slowest workload: 32 reads of 50 kb, score-only.
    arr = np.frombuffer(genome.encode("latin1"), dtype=np.uint8)
    recs50 = sim.simulate_reads(arr, (50000,) * 32,
                                np.random.default_rng(GENOME_SEED + 7))
    return {"phase": 4, "reads": len(recs),
            "score": profile_cell(genome, recs, MapperConfig()),
            "cigar": profile_cell(genome, recs,
                                  MapperConfig(output_cigar=True)),
            "longread_50k": profile_cell(genome, recs50, MapperConfig())}


def profile_cell(genome: str, recs, cfg) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper
    dev = torch.device("cuda", 0)
    res: dict = {}
    for profiled in (False, True):
        mapper = Mapper([("ecoli_like", genome)], cfg, device=dev)
        mapper.device_index()
        for name in ("fresh", "adapted"):
            before = mapper.counters.as_dict()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if profiled else None
            if prof:
                prof.start()
            t0 = time.perf_counter()
            mapper.map_records(recs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = mapper.counters.as_dict()
            row = {"wall_s": wall, "reads_per_s": len(recs) / wall,
                   "realign_batches": after["realign_batches"]
                   - before["realign_batches"],
                   "cert_misses": (after["cert_total"] - after["cert_hits"])
                   - (before["cert_total"] - before["cert_hits"]),
                   "counters": {k: after[k] - before.get(k, 0)
                                for k in after if k != "cert_hit_rate"
                                and isinstance(after[k], (int, float))},
                   # The bucket bands the pass ended with: "cap,for_cigar".
                   "bands": {f"{cap},{int(fc)}": band for (cap, fc), band
                             in mapper._band_by_key.items()}}
            if prof:
                prof.stop()
                busy, top = device_time(prof)
                check(busy > 0, "the profiler recorded no device time")
                row.update(device_busy_s=busy, busy_share=busy / wall,
                           top_device=top)
            res[f"{name}{'_profiled' if profiled else ''}"] = row
        del mapper
        torch.cuda.empty_cache()
    return res


def main() -> int:
    profile_map = "--profile-map" in sys.argv[1:]
    lpt_trial = "--lpt-trial" in sys.argv[1:]
    if lpt_trial:
        os.environ["BIOINFO1_NVCC_DEFINES"] = "BIOINFO1_BAND_LPT_TRIAL"
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 1
    from bioinfo1_tpu_torch.kernels import build

    if os.path.exists(LOG):
        os.remove(LOG)
    # Fresh band adaptation in every run (the CLI phases, the phase 3 CPU
    # runs).
    os.environ["BIOINFO1_BAND_CACHE"] = "0"
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built_s = build.ensure_built()
    build.library()
    build_s = time.perf_counter() - t0
    with open(build.NVCC_LOG) as fh:
        log = fh.read().splitlines()
    ptxas = [line.strip() for line in log
             if "registers" in line or "Compiling entry" in line]
    spills = [line.strip() for line in log if "spill" in line
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    emit({"phase": 0, "device": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_s": built_s, "spills": spills,
          "ptxas": ptxas})

    if lpt_trial:
        emit(phase_lpt_trial(dev))
        return 0
    rows = phase_kernels(dev)
    emit({"phase": 1, "kernels": rows})
    listing = build.sass()
    with open(os.path.join(WORK, "kernels.sass"), "w") as fh:
        fh.write(listing)
    issued = issued_per_unit(listing)
    torch.cuda.empty_cache()

    ref, paths, recs, genome, short = write_inputs()
    p2, score_lines = phase_pipeline(ref, paths[N_READS], recs)
    emit(p2)
    p2c, gpu_lines = phase_cigar(ref, paths, recs)
    emit(p2c)
    p2s, staged_lines = phase_staged(ref, paths, recs)
    emit(p2s)
    gpu_lines.update(staged_lines, score=score_lines)
    p2r = phase_repeat_and_roofline(dev)
    emit(p2r)
    torch.cuda.empty_cache()
    emit(phase_cpu_crosscheck(ref, paths, recs, gpu_lines, short))
    if profile_map:
        emit(phase_profile(genome, recs))

    # Launches on each kernel's own path: the score-only run (phase 2) for
    # K1-K3, the -c runs (phase 2c) for K4 and K5, the roofline (phase 2r)
    # for K6.
    path_launches = dict(p2["launches"])
    for name in ("band_parents", "walk_parents"):
        path_launches[name] = p2c["launches"][name]
    path_launches["int32_probe"] = p2r["launches"]["int32_probe"]
    needed = NEEDED_OPS
    table = []
    for name, (source, replaces) in KERNELS.items():
        main_row = rows[name][0]
        check(path_launches[name] >= 1, f"{name} never launched on its path")
        bound_ms, bound_by = bound(main_row, needed[name])
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces,
                      "launches": path_launches[name],
                      "max_abs_err": max(r["max_abs_err"]
                                         for r in rows[name]),
                      "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      # No single PyTorch call computes any of these DPs,
                      # the walk or the probe.
                      "library_ms": None,
                      "shape": main_row["call"], "work": main_row["work"],
                      "unit": main_row["unit"], "bytes": main_row["bytes"],
                      "swept": main_row.get("swept"),
                      "needed_ops_per_unit": needed[name],
                      "int_ops_per_unit": issued[name],
                      "issued_over_needed":
                          issued[name] * (main_row.get("swept")
                                          or main_row["work"])
                          / (needed[name] * main_row["work"])
                          if needed[name] else None,
                      "staged_launches": p2s["launches"][name],
                      "repeat_launches": p2r["launches"][name]})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
