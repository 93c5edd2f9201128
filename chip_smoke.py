"""Chip smoke test of the PyTorch + CUDA port (bioinfo1_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile-map | --lpt-trial | --walk-trial |
                           --chain-trial | --chain-profile |
                           --wide-trial [--parent DIR] | --full-trial |
                           --strip-trial | --epoch-trial |
                           --megabase-trial [--parent DIR] |
                           --split-trial |
                           --shard-trial [--genome-mb N] | --process-trial]

Phases, in this order (each prints one JSON line; any mismatch fails the
run):
  0. device: card, torch and CUDA versions, nvidia-smi name and power
     limit; builds the CUDA kernels from bioinfo1_tpu_torch/csrc.
  1. every kernel against its plain PyTorch version on the card, exact
     integer equality, with both times and the work the function needs
     (matrix cells, window pairs, steps, bytes; the lanes or pairs a
     kernel sweeps beside them): K1 LIS chain (phase 1's rows at three
     budgets, each row naming its ops/chain.chain_plan path, and the match
     rows the 50 kb reads of phase 2L give it on the main path; its wide
     path on the rows of the ~150 kb read's fused call, N = 73,728, of the
     ~250 kb read's largest call, N = 196,608, and on a colinear row of
     70,000, whose lis and predecessors pass 65,535, timed beside a flat
     row of the same pair tests: the pointer chase's share; past 2,097,152
     matches on the rows of the 4.2 Mb read's fused call, N = 2,359,296,
     and on a colinear row of 2,200,000, whose q_lo pass 65,535, held to
     its closed form, its prologue, DP and chase timed apart by a
     measurement build of K1, chain_profile_split), K2 banded
     score, K3 full score (every mode on one strip, B = 64, n = 512, and
     on several, B = 32, n = 4,608; a one-row last strip; more reads than
     fill whole CTAs; each row naming its ops/align.full_plan rows per
     thread, strips and warps per CTA), K4
     banded score + parents (parents compared on the cells they are
     defined on, ops/band.parent_cells), K5 traceback walk (on each K4
     parent tensor; K4 and K5 also at a band that covers the whole
     matrix; K5 timed with its parents out of L2 and in it), K6 int32
     probe.  K2 and K4 run on every dispatch path of
     ops/band.band_plan, each row naming its path, lanes per thread,
     cluster size and threads per CTA: one warp per read (W = 128, 256;
     also with more reads than fill whole CTAs), several warps per read
     (W = 512, 1024, 4096), a thread-block cluster per read (W = 19968,
     24576) and strips on co-resident CTAs (W = 32896, 65536; K4 and K5
     at W = 32896), all three modes and both dash_free settings on each;
     every strip row is also held to the scratch kernel on the same
     inputs, which is timed beside it.  Then K2 and K4 on the cluster path at
     the 50 kb reads' shape (11 reads of ~46 kb, W = 25088) against the
     plain version and the scratch kernel on the same inputs, the scratch
     kernel timed too, K5 on those parents against the plain walk; K2 (2
     reads) and K4 (1 read, the -c chunk) on strips at the 100 kb reads'
     realign shape (~96-100 kb against regions 3,000 bases longer, W =
     65536) against the plain version, every parent byte of the rows K4
     writes (the kernel table's strip rows); the strip card the plan read
     (ops/band.strip_card) and the clusters the card holds at once
     (cudaOccupancyMaxActiveClusters) for 2-8 CTAs of 512 threads.  K2's
     "epochs" path (past the card's w_strip): 2 reads of ~8 kb at W =
     540,800, each mode, against the plain version and the scratch kernel
     (timed too); 8 reads of 100 kb at W = 65,536 forced onto it, held to
     the strips and timed beside them in turns.
  2a. the pinned golden workload (tests/torch_golden.json; its files from
     bioinfo1_tpu_torch/utils/golden.py): bioinfo1_tpu_torch.map_all with
     no device argument (on the card) on its reads, then the CLI's eight
     runs (-a global / local / semiGlobal, score-only and -c; -g 1;
     -c -g 1); every PAF's sha256 must be the pinned one (made from the
     JAX package's CLI), each run's kernels must launch (K1, K2 and K3;
     K1, K4 and K5 under -c; K1 and K3 under -g 1) and no batch may raise.
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
  2g. the CLI score-only where no exactness certificate exists, so every
     bucket takes K3 in the fused step: -g 1 on the first 512 reads, -a
     local -g 1 on the first 256; K1 and K3 must launch, K2 must not, no
     realign pass may run, >= 90% of reads >= 2 kb must map; reads/s.
  2s. the staged host path through the CLI: -c -g 1 and -c -a local -g 1
     (no exactness certificate) on the first 256 reads, and --bug-compat
     on a FASTA copy of the first 512 (FASTA match nesting, score-only);
     t_host_s > 0 and K1, K4 and K5 (K3 in the FASTA run) launched.
  2d. batches dealt to two streams of cuda:0 (parallel/shard.py, one
     index copy): Mapper(devices=[cuda:0, cuda:0]) on phase 2's 2,048
     reads in-process, score-only and then -c, beside a one-entry mapper;
     batch by batch their results and counters (but the timings) must be
     equal; then four passes on adapted bands (one entry, two, two, one):
     K1, K2 and K3, then K1, K4 and K5 must launch (from the batch
     threads), both entries must be dealt batches and every pass's PAF
     must equal phase 2's and phase 2c's -c run byte for byte; reads/s of
     each pass beside the CLI run's.
  2x. the hash-range-sharded index (BIOINFO1_INDEX_SHARD=1,
     parallel/shard.shard_index) on Mapper(devices=[cuda:0, cuda:0]): two
     shards, two batch streams, the card's lookup stream; phase 2's reads
     in-process, score-only and then -c, beside the replicated two-entry
     mapper: batch by batch their results and counters (but the timings)
     must be equal; then four passes on adapted bands (sharded,
     replicated, replicated, sharded), each PAF phase 2's or phase 2c's -c
     run's byte for byte, phases 2 / 2c's kernels launched, no batch
     raised, both shards served lookups; each shard's bytes, both indexes'
     bytes, the card's peak memory, reads/s of each pass.
  2p. two CLI processes on cuda:0 under the multi-process variables
     (JAX_COORDINATOR_ADDRESS=127.0.0.1:<free port>, JAX_NUM_PROCESSES=2,
     JAX_PROCESS_ID=p; each through this file's --process-worker, which
     runs bioinfo1_tpu_torch.cli.main in-process with --profile and writes
     its launches by kernel and by card, its mapper counters, its stages
     and its peak memory as JSON) on phase 2's inputs: score-only to
     stdout (process 0's stdout must be phase 2's PAF byte for byte,
     process 1's empty), then -c -o (the merged file must be phase 2c's -c
     PAF, the two part files must concatenate to it, both progress files
     must read complete); K1, K2 and K3, then K1, K4 and K5 must launch in
     each process, with faults 0; the pair's wall, each process's map and
     merge seconds, map-stage reads/s and peak memory beside phase 2's
     one-process run.
  2L. the main path at 50 kb: 16 ONT-profile reads of 50 kb from the
     bench's genome through Mapper.map_records in-process (score-only,
     fresh bands): as planned (their bands take the cluster path, which
     must have launched), then with ops/band.band_plan sending every band
     past W_REG to the scratch kernel, then as planned again; the three
     PAFs must be byte-identical; reads/s of each run.
  2U. the main path at 100 kb: 8 ONT-profile reads of 100 kb from the
     bench's genome through Mapper.map_records in-process, score-only, a
     fresh and an adapted pass (realign at W = 65,536, then the fused step
     at the proved band: both on strips, which must launch in each pass),
     then both passes again with ops/band.band_plan sending every band past
     W_CLUSTER to the scratch kernel, then every score-only band past it to
     K2's "epochs" path: each run's path alone launched, the PAFs of a pass
     byte-identical, faults 0; reads/s of each pass.  Then -c on 2 of the
     reads (K4 on strips, one read a chunk, and K5): every CIGAR spans its
     PAF line's extents and scores, recomputed on the host, the score-only
     run's score.  Two reads of ~98 kb (the 98,304 bucket, whose doubled
     match budget, 73,728, takes K1's wide path) must map with no fault
     and give C11_OUTCOME's PAF.  Then the second golden recipe
     (tests/torch_golden_ultra.json): a ~150 kb and a ~250 kb read on a
     600 kb genome, each alone, fresh and adapted passes, as planned and
     with K2's "epochs" path forced past W_CLUSTER: K1's wide path and the
     route's path launched (strips or epochs, never both), faults 0, each
     PAF at its pinned sha256 (the JAX CLI's on the CPU for the ~150 kb
     read, the port's CPU run's for the ~250 kb one).
  2W. match budgets past 2,097,152 on the main path (ROADMAP C12,
     closed): a read of 4,200,000 bases (tests/torch_golden_4mb.json, the
     6,291,456 bucket, base match budget 2,359,296) alone, in-process, a
     fresh and an adapted pass: K1's wide path launched, faults 0, one
     line at the sha256 pinned from the port's CLI on the CPU; the first
     golden recipe's reads with every match budget forced to 4,194,304:
     every K1 call wide, faults 0, the default run's pinned sha256.
  2E. the default route on a megabase read (tests/torch_golden_mb.json):
     one ONT-profile read of 1,199,829 bases from the bench's genome
     alone, in-process, a fresh and an adapted pass: faults 0, one PAF line
     at the pinned sha256, K2's "epochs" path launched and the scratch
     kernel never, the fresh pass realigning at W = 2^20.  Its captured
     realign pair gives the kernel table's megabase rows: at the card's
     w_strip (540,672) on strips and on epochs, held equal, timed in turns;
     at 2^20 on epochs, timed.
  2r. bench_torch.measure_repeat() at full size (a 4,641,652 bp
     repeat-structured genome, 1,026 + 1,026 reads, score-only and -c)
     with its reads/s and counters, then bench_torch.measure_sol(): K6's
     int32 rate, K2's fill rate, the int32 instructions per cell and the
     SM clock.
  3. with BIOINFO1_PLATFORM=cpu in subprocesses, started after phase 2s
     and running beside phases 2d-2r: the first 96
     reads score-only and under -c, the first 32 under -c -a local, and 32
     reads of at most 4.5 kb under -g 1, -c -g 1 and (as FASTA)
     --bug-compat; their PAF lines must equal the GPU runs' byte for byte.
  4. only with --profile-map: the map stage alone on phase 2's inputs,
     score-only and -c, on phase 2g's (-g 1, the first 512 reads), and on
     32 reads of 50 kb score-only, fresh and
     with adapted bands, without and then under torch.profiler (device
     busy time and share, device time and launches by kernel, the
     mapper's counters of each pass), then with a third mapper under
     utils/tracing.device_trace (every thread; the trace files go to
     build/chip_smoke/traces/): the host time by scope (calls, threads,
     inclusive and exclusive s), the main thread's wall split into waiting
     for batches, formatting and the rest, the batch threads' time split by
     scope, and the device busy share.

  With --lpt-trial phase 0 builds K2 / K4 with every lanes-per-thread
  variant, phase 1t times them at the phase-1 pairs (the table behind
  ops/band.WARP_LPT and WARPS_LPT), and the run ends there.
  With --strip-trial phase 1u times K2 / K4's strip path alone: against
  the scratch kernel at the kernel table's shape (W = 32,896, B = 32, n =
  4,096; K4 at B = 16) and at the 100 kb reads' realign shape (W =
  65,536, 8 reads of ~100 kb; K4 on one), against the cluster path at
  its 50 kb shape (W = 25,088, strips forced), each strip width the card
  holds at the table's shape and at 1, 2, 4, 6, 8 and 12 reads of 100 kb
  (K4 at one), the bound of every row and the strip kernel's integer
  instructions per cell; outputs must be equal; the run ends there.
  With --epoch-trial (the library built with BIOINFO1_BAND_EPOCH_TRIAL)
  phase 1e times K2's "epochs" path at W = 2^20 on one ~1.2 Mb read at
  every strip width and halos of 32 and 64 lanes (the trial behind
  ops/band.EPOCH_WIDTH and EPOCH_HALO), and its launches alone on an empty
  read.  With --megabase-trial [--parent DIR] phase 1m runs the megabase
  read through this tree's CLI and, with DIR (an older tree's checkout),
  through that tree's (the scratch kernel past w_strip: the pin of
  tests/torch_golden_mb.json).  Both runs end there.
  With --walk-trial phase 1w times K5 alone (cold / L2-warm, the 50 kb
  parents, bench_torch's long-read rates) and the run ends there; it uses
  nothing that K5's wrapper did not have before its redesign, so a copy
  of this file run from an older tree's root times that tree's K5.
  With --chain-trial phase 1c times K1 alone in the same way (phase 1's
  rows at R = 1 and 512, the 50 kb reads' rows, the pointer chase's share,
  every threads-per-CTA choice) and the run ends there; --chain-profile
  runs it on K1's measurement build, which also counts the SM clocks of
  each phase of a one-row call.  With --wide-trial phase 1x times K1's
  wide path past 2,097,152 matches (phase_wide_trial: the colinear row's
  prologue with and without the q_lo scan start, the 4.2 Mb read through
  the CLI; with --parent DIR, an older tree's checkout, that tree's CLI on
  the read and its K1 paired with this one's in one process) and the run
  ends there.  With --full-trial phase 1f times K3
  alone (the kernel table's shape, the 8 kb bucket's fused call captured
  from a run like phase 2g's -g 1 one, 16 reads of 50 kb; every
  rows-per-thread choice) and the run ends there; like the other trials
  it runs from an older tree's root too.  With --split-trial phase 2m
  runs the CLI on phase 2's inputs with --devices 1 and then --devices 0
  (every visible card, the largest power-of-two prefix), score-only and
  -c: the PAFs must be byte-identical, no batch may raise, each card must
  hold an index copy and launch kernels; then a one-card and an all-card
  mapper in-process, a fresh pass each and six timed passes (one, all,
  all, one, one, all), every PAF the same; reads/s of each; and the run
  ends there.  With --shard-trial phase 2y holds the sharded index over
  every visible card to the replicated one: the CLI with --devices 0
  under BIOINFO1_INDEX_SHARD=0 and =1, score-only and -c (byte-identical
  PAFs, no batch raised, every card launched, each card's peak memory),
  then in-process passes interleaved (rep, shard, shard, rep, rep, shard)
  with their reads/s; --genome-mb N adds phase 2z, the CLI pair on an N
  Mb genome, replicated against auto with the budget lowered to 1e9 so
  that auto itself shards (each card's peak must drop by > 2 GB); the
  run ends there.  With --process-trial phase 2q runs the CLI as several
  processes over every visible card, each PAF held to the one-card
  one-process run of the same flags (in-process, --devices 1): (a) one
  process a card (CUDA_VISIBLE_DEVICES=p), score-only to stdout and -c
  -o; (b) with four cards or more, two processes of two cards each with
  --devices 0, under BIOINFO1_INDEX_SHARD=0 and =1 (each process launching
  on both of its cards); (c) the kill drill, on the reads of one length
  bucket: process 1 held after its first checkpointed batch (--batch-size
  32, one batch in flight), mid-slice, then SIGKILLed; process 0
  must exit non-zero within 30 s naming process 1 and --resume, and every
  process rerun with --resume must merge the one-process PAF; the run ends
  there.  These three trials are the modes that use more than one card.

  Every CLI run and in-process mapper of every phase must end with the
  mapper's ``faults`` at 0: a batch that raised (and was isolated by
  map_batch) fails the run.

The genome and reads come from bioinfo1_tpu_torch/utils/simulate.py.

The second-to-last line is the kernel table as JSON: per kernel (K1-K6,
K2's cluster path as its own entry, launched on phase 2L, K2's and K4's
strip path and K1's wide path, launched on phase 2U, K2's "epochs" path,
launched on phase 2E) its
launches on its path, its time, the plain version's, and its bound - the
larger of its bytes over the card's memory rate and the int32 operations
the function needs (NEEDED_OPS per unit, times this run's cells inside
the matrix) over the card's issue rate.  What the kernel's own SASS loop
issues per unit stands beside it (int_ops_per_unit, issued_over_needed)
and moves no bound; the line before the table gives the run's wall
seconds, the build included.  The last line is {"ok": true, "device":
{...}}.
Exits non-zero, printing no result, when no CUDA device is visible.
Scratch files go to build/chip_smoke/, and every JSON line printed is also
appended to build/chip_smoke/smoke.jsonl (the whole record, where a
terminal keeps only the end of the output).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
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
N_LONG_READS = 16                 # 50 kb reads (phase 2L)
N_ULTRA_READS = 8                 # 100 kb reads (phase 2U)
W_100K = 65536                    # their realign band
N_ULTRA_CIGAR_READS = 2           # of them under -c (phase 2U)
ULTRA_LEN = 100000
# The ONT profile (3% insertions, 4% deletions) makes a read ~1.7% shorter
# than its fragment: fragments of 101,700 bases give reads of 99.7-100.3
# kb.  Fragments of 100,000 give reads of 98.1-98.6 kb, some in the 98,304
# length bucket, whose base match budget (36,864) they overflow; the retry
# doubles it to 73,728, which K1 runs on its wide path (ROADMAP C11, closed):
# phase 2U maps two of those apart.
ULTRA_FRAGMENT = 101700
# What those two reads give (ROADMAP C11): no fault, both mapped, the PAF's
# sha256 that of the port's CLI on the CPU, the plain version of every
# kernel (the bench's genome as "bench", the two reads as FASTQ, default
# flags; the JAX CLI's fused step asks for tens of GB of host memory on
# them in interpret mode).  Before the wide path: two faults and no line.
C11_SHA256 = ("a1d93eefe083056270b1acbece94b174"
              "4266af1e25df8f821cb435435a4101d5")
C11_OUTCOME = {"reads": [98096, 98218], "faults": 0, "paf_lines": 2,
               "sha256": C11_SHA256}
N_NOCERT_READS = 512              # -g 1 (phase 2g)
N_NOCERT_LOCAL_READS = 256        # -a local -g 1 (phase 2g)
CPU_STAGED_MAX_LEN = 4500
GOLDEN = os.path.join(REPO, "tests", "torch_golden.json")   # phase 2a
# Phase 2U's reads past 131 kb: a ~150 kb and a ~250 kb read, each a run of
# this second golden recipe, pinned from a CLI on the CPU (the JAX
# package's, or the port's where the JAX CLI does not finish).
GOLDEN_ULTRA = os.path.join(REPO, "tests", "torch_golden_ultra.json")
# Phase 2W's read past 4.19 Mb: 4,200,000 bases, a genomic fragment inside
# random sequence, in the 6,291,456 length bucket, whose base match budget
# (2,359,296) is past the 2,097,152 of K1's wide path while it kept q_lo in
# shared memory (ROADMAP C12, closed); pinned from the port's CLI on the
# CPU.  On the card, before: two faults (the fused step and the host path
# each refused the budget) and no line; now C12_OUTCOME.
GOLDEN_4MB = os.path.join(REPO, "tests", "torch_golden_4mb.json")
C12_OUTCOME = {"reads": [4200000], "faults": 0, "paf_lines": 1}
# Phase 2W forces every match budget of the first golden recipe's reads to
# this (MapperConfig.initial_match_budget): every K1 call past 2,097,152.
FORCED_BUDGET = 1 << 22
# Phase 2E's megabase read (tests/torch_golden_mb.json): one ONT-profile
# read of a fragment of MB_FRAGMENT bases of the bench's genome, from a
# generator seeded bench_torch.SEED + MB_SEED_OFFSET: 1,199,829 bases, in
# the 1,572,864 length bucket; its fused pass's hint is past 524,288, so
# its realign band is W_MB lanes, past an H100 SXM's w_strip: K2's
# "epochs" path.
GOLDEN_MB = os.path.join(REPO, "tests", "torch_golden_mb.json")
MB_FRAGMENT = 1_220_000
MB_SEED_OFFSET = 72
W_MB = 1 << 20
# The first multiple of 128 past an H100 SXM's w_strip (540,672): phase 1's
# "epochs" rows, against the scratch kernel that K2 took there before.
W_PAST_STRIP = 540800
# K1's wide path on a colinear row of this many matches (phase 1): 68,750
# chunks, their q_lo past 65,535; held to its closed form.
WIDE_COLINEAR_N = 2_200_000
# K1's wide path on a colinear row of this many matches (phase 1): lis and
# the chosen predecessors pass 65,535, and the chase walks every match.
WIDE_CHASE_N = 70000
# Phase 1 draws, from one generator: K1's rows at these (R, N), then the
# (B, n, m) pairs of the kernel table's K2 / K4 / K5 rows (W = 256).
CHAIN_SHAPES = ((512, 1536), (64, 16384), (64, 24576))
WALK_PAIRS = (256, 4096, 6144)
L2_FLUSH_BYTES = 256 << 20        # written between cold launches: > 5 x L2

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
#   step (K5): extract the 2-bit code (a shift and a mask), move i and j (two
#     subtracts) and the next byte's offset (one add): 5.  A step's time is
#     its place in a chain of dependent loads, which no count of operations
#     bounds.
#   trip (K6): the adds and maxes its source writes, 2 * ILP * UNROLL.
NEEDED_OPS = {
    "lis_chain": 5,
    "lis_chain_wide": 5,
    "band_score": bench_torch.NEEDED_OPS_PER_CELL,
    "band_score_cluster": bench_torch.NEEDED_OPS_PER_CELL,
    "band_score_strip": bench_torch.NEEDED_OPS_PER_CELL,
    "band_score_epochs": bench_torch.NEEDED_OPS_PER_CELL,
    "full_score": bench_torch.NEEDED_OPS_PER_CELL,
    "band_parents": bench_torch.NEEDED_OPS_PER_CELL + 5,
    "band_parents_strip": bench_torch.NEEDED_OPS_PER_CELL + 5,
    "walk_parents": 5,
    "int32_probe": bench_torch.probe.source_ops(1, 1),
}

KERNELS = {
    "lis_chain": ("bioinfo1_tpu_torch/csrc/lis_chain.cu",
                  "bioinfo1_tpu/ops/pallas_chain.py:57"),
    # K1's wide path (match budgets past 65,535): reads of ~98 kb that
    # overflow, and reads past 131 kb.
    "lis_chain_wide": ("bioinfo1_tpu_torch/csrc/lis_chain.cu",
                       "bioinfo1_tpu/ops/pallas_chain.py:57"),
    "band_score": ("bioinfo1_tpu_torch/csrc/band_score.cu",
                   "bioinfo1_tpu/ops/pallas_band.py:56"),
    # K2's cluster path (kRegMaxW < W <= 32,768): the 50 kb reads' bands.
    "band_score_cluster": ("bioinfo1_tpu_torch/csrc/band_score.cu",
                           "bioinfo1_tpu/ops/pallas_band.py:56"),
    # K2 / K4's strip path (32,768 < W <= 540,672): reads of ~66 kb and more
    # (band_strip_kernel).
    "band_score_strip": ("bioinfo1_tpu_torch/csrc/band_score.cu",
                         "bioinfo1_tpu/ops/pallas_band.py:56"),
    # K2's "epochs" path (W past the card's w_strip, 540,672 on an H100
    # SXM): reads of ~1.1 Mb and more (band_epoch_kernel).
    "band_score_epochs": ("bioinfo1_tpu_torch/csrc/band_score.cu",
                          "bioinfo1_tpu/ops/pallas_band.py:56"),
    "full_score": ("bioinfo1_tpu_torch/csrc/full_score.cu",
                   "bioinfo1_tpu/ops/pallas_align.py:45"),
    "band_parents": ("bioinfo1_tpu_torch/csrc/band_score.cu",
                     "bioinfo1_tpu/ops/pallas_band.py:56"),
    "band_parents_strip": ("bioinfo1_tpu_torch/csrc/band_score.cu",
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
    """The error of two banded outputs with parents: max_abs_err of score
    and goal cells, and the number of cells where the parents differ on
    the cells they are defined on (0 when equal)."""
    def err(got, want):
        return max(max_abs_err(got.score, want.score),
                   max_abs_err(got.goal_i, want.goal_i),
                   max_abs_err(got.goal_j, want.goal_j),
                   parents_err_chunked(got.parents, want.parents, q_lens,
                                       t_lens, m_eff))
    return err


@contextlib.contextmanager
def band_plan_as(make):
    """ops/band.band_plan replaced by ``make(planned)`` for the body, where
    ``planned`` is the real one (the control runs of the strip path)."""
    from bioinfo1_tpu_torch.ops import band as bd
    planned = bd.band_plan
    bd.band_plan = make(planned)
    try:
        yield
    finally:
        bd.band_plan = planned


def scratch_past_cluster(planned):
    """A band_plan with the scratch kernel for every band past W_CLUSTER
    (the path such bands took before the strip path), else ``planned``."""
    from bioinfo1_tpu_torch.ops import band as bd

    def plan(W: int, B: int, want_parents: bool, card=None):
        if W > bd.W_CLUSTER:
            return bd.scratch_plan(W, want_parents)
        return planned(W, B, want_parents, card)
    return plan


def epochs_past_cluster(planned):
    """A band_plan with K2's "epochs" path for every score-only band past
    W_CLUSTER (the forced route of phase 2U), else ``planned``: K4 keeps
    its plan."""
    from bioinfo1_tpu_torch.ops import band as bd

    def plan(W: int, B: int, want_parents: bool, card=None):
        if W > bd.W_CLUSTER and not want_parents:
            return bd.epoch_plan(W)
        return planned(W, B, want_parents, card)
    return plan


def epochs_at(width: int, halo: int):
    """A band_plan factory: every call on the "epochs" path in strips of
    ``width`` lanes with ``halo`` lanes a side (the epoch trial's)."""
    from bioinfo1_tpu_torch.ops import band as bd
    return lambda planned: (lambda W, B, want_parents, card=None:
                            bd.epoch_plan(W, width, halo))


def strip_always(planned):
    """A band_plan with the strip kernel for every band (a trial's)."""
    from bioinfo1_tpu_torch.ops import band as bd
    return lambda W, B, want_parents, card=None: bd.strip_plan(W, B, card)


def strip_width(S: int):
    """A band_plan factory: strips of S lanes wherever the plan takes
    strips (a trial's), as few launches as the card holds."""
    from bioinfo1_tpu_torch.ops import band as bd

    def make(planned):
        def plan(W, B, want_parents, card=None):
            got = planned(W, B, want_parents, card)
            return (bd.strip_plan(W, B, card, width=S)
                    if got.path == "strip" else got)
        return plan
    return make


def against_scratch(row: dict, run, err_fn, got,
                    time_the_check: bool = False) -> None:
    """Hold a row's output ``got`` to the scratch kernel on the same inputs
    (``run()`` under scratch_past_cluster) and time that kernel in the
    same call: the time the row's path replaces.  With
    ``time_the_check`` the checked call is the timed one (a scratch call
    of seconds needs no second)."""
    with band_plan_as(scratch_past_cluster):
        if time_the_check:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            want = run()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop)
        else:
            want = run()
        err = err_fn(got, want)
        check(err == 0, f"{row['call']}: the {row.get('path')} path "
                        f"differs from the scratch kernel (max abs err "
                        f"{err})")
        row.update(scratch_ms=ms if time_the_check else cuda_ms(run, 1),
                   max_abs_err_vs_scratch=err)


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


def full_work(q, ql, t, tl) -> dict:
    """What a full-matrix call needs: the cells inside each pair's matrix
    (q_len x t_len) and its bytes (inputs and lengths read once, three
    outputs written once), with the launch of ops/align.full_plan.
    ``swept``: the cells K3 visits - per read and strip of S rows, S lanes
    on each diagonal from r0 + 2 to min(r0 + S, q_len) + t_len, in whole
    pairs of diagonals; on a tree without full_plan (one CTA per read),
    its lanes 0..n on every diagonal up to q_len + t_len."""
    from bioinfo1_tpu_torch.ops import align as al
    B, n = q.shape
    qa = ql.long().clamp(0, n).cpu().numpy()
    ta = tl.long().clamp(0, t.shape[1]).cpu().numpy()
    out = {"work": int((qa * ta).sum()), "unit": "cells",
           "bytes": q.numel() + t.numel() + 20 * B}
    plan_of = getattr(al, "full_plan", None)
    if plan_of is None:
        diags = np.clip(qa + ta - 1, 0, None)
        out.update(swept=int(diags.sum()) * (n + 1), strip_rows=None)
        return out
    plan = plan_of(n, B)
    S = plan.strip_rows
    swept = 0
    for a, b in zip(qa.tolist(), ta.tolist()):
        for r0 in range(0, a if b > 0 else 0, S):
            diags = min(S, a - r0) + b - 1
            swept += S * (diags + (diags & 1))
    out.update(swept=swept, strip_rows=S, lpt=plan.lpt, strips=plan.strips,
               warps_per_cta=plan.warps_per_cta, grid=plan.grid)
    return out


def phase_kernels(dev) -> dict:
    from bioinfo1_tpu_torch.ops import align as al
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.ops import probe
    from bioinfo1_tpu_torch.ops import trace as tr
    rng = np.random.default_rng(1)
    rows = {name: [] for name in KERNELS}
    chain_split = chain_profile_split()     # nvcc in the background

    for R, N in CHAIN_SHAPES:
        f, r, cnt = chain_inputs(rng, R, N, dev)
        rows["lis_chain"].append(chain_row(f"lis_chain R={R} N={N}", f, r,
                                           cnt, 3 if N <= 1536 else 1))

    scoring = (1, -1, -1)
    q, ql, t, tl = pair_inputs(rng, *WALK_PAIRS, dev)

    def plan_of(B, W, want_parents):
        """Which kernel of csrc/band_score.cu the row ran on."""
        plan = bd.band_plan(W, B, want_parents, bd.strip_card(dev))
        return {"path": plan.path, "lpt": plan.lpt,
                "reads_per_cta": plan.reads_per_cta,
                "cluster": plan.cluster,
                "threads_per_cta": plan.threads_per_cta,
                "strip": plan.strip, "strips": plan.strips,
                "reads_per_launch": plan.reads_per_launch}

    def band_row(pairs, W, mode, dash_free, reps):
        qq, qql, tt, ttl = pairs
        B = qq.shape[0]

        def run():
            return bd.align_scores_banded(qq, qql, tt, ttl, *scoring, band=W,
                                          mode=mode, dash_free=dash_free)
        row, got = compare(
            f"band W={W} B={B} n={qq.shape[1]} mode={mode} "
            f"dash_free={dash_free}", run,
            lambda: bd.align_scores_banded_plain(
                qq, qql, tt, ttl, *scoring, band=W, mode=mode,
                dash_free=dash_free), reps=reps, keep=True)
        row.update(plan_of(B, W, False))
        row.update(band_work(qq, qql, tt, ttl, W, False))
        rows["band_score"].append(row)
        if row["path"] in ("cluster", "strip"):
            rows[f"band_score_{row['path']}"].append(row)
        if row["path"] == "strip":
            against_scratch(row, run, max_abs_err, got)

    def first(B):
        return [x[:B].contiguous() for x in (q, ql, t, tl)]

    # The fused step's shape on the one-warp path, every mode and variant
    # (the first row is the kernel table's).
    for mode in (0, 1, 2):
        for dash_free in (True, False):
            band_row((q, ql, t, tl), 256, mode, dash_free, 3)
    # Every dispatch path at the same pairs: one warp per read (W = 128),
    # several warps (W = 512 ... 4096), a cluster per read (W = 24576 and
    # 19968), strips (W = 32896: 33 strips of 1,024 lanes in 2 launches on
    # an H100 SXM; 65536: 16 strips of 4,096, one launch), each strip row
    # beside the scratch kernel.
    for B, W in ((256, 128), (256, 512), (256, 1024), (256, 4096),
                 (32, 24576), (32, 19968), (32, 32896), (8, 65536)):
        band_row(first(B), W, 0, True, 3 if W <= 1024 else 1)
    # Small pairs: every mode and variant on the several-warps, the cluster
    # and the strip path, and a B that is no multiple of the reads per CTA.
    small = pair_inputs(rng, 12, 600, 900, dev)
    many = pair_inputs(rng, 531, 512, 768, dev)
    check(bd.band_plan(128, 531, False).reads_per_cta > 1
          and 531 % bd.band_plan(128, 531, False).reads_per_cta,
          "531 reads fill whole CTAs: the ragged last CTA is not driven")
    for mode in (0, 1, 2):
        for dash_free in (True, False):
            for W in (512, 19968, 32896):
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
        if row["path"] == "strip":
            rows["band_parents_strip"].append(row)
            against_scratch(row, lambda: bd.align_scores_banded(
                qq, qql, tt, ttl, *scoring, band=W, mode=mode,
                dash_free=dash_free, want_parents=True),
                parents_err(qql, ttl, m_eff), out)
        walk_args = (out.parents, out.goal_i, out.goal_j, out.score, qq, tt,
                     *scoring, mode)
        wrow, codes = compare(
            f"walk W={W} B={B} n={qq.shape[1]} mode={mode}",
            lambda: tr.walk_parents(*walk_args),
            lambda: tr.walk_parents_plain(*walk_args), reps=3, keep=True)
        wrow.update(walk_work(codes, B))
        rows["walk_parents"].append(wrow)
        return out.score

    # K4 at the fused -c shape in each mode, then the other widths of the
    # register paths (the last two are wide realign calls: the cluster
    # path, and strips).
    for B, W, mode in ((256, 256, 0), (256, 256, 1), (256, 256, 2),
                       (256, 128, 0), (256, 512, 0), (128, 1024, 0),
                       (32, 4096, 0), (16, 24576, 0), (16, 32896, 0)):
        parents_and_walk(*first(B), W, mode, True, 3 if W <= 256 else 1)
    rows["walk_cache"] = walk_cache_rows(dev, q, ql, t, tl)
    del q, ql, t, tl
    # Small pairs: every mode and variant on the several-warps, the cluster
    # and the strip path; the ragged last CTA of the one-warp path.
    for mode in (0, 1, 2):
        for dash_free in (True, False):
            for W in (512, 19968, 32896):
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

    # K3: one strip (the kernel table's shape, first row), several strips,
    # a one-row last strip, and more reads than fill whole CTAs; every
    # mode, gap < 0 and (on the several-strip pairs) gap > 0.
    def full_row(pairs, mode, sc, reps):
        qq, qql, tt, ttl = pairs
        row = compare(
            f"full B={qq.shape[0]} n={qq.shape[1]} m={tt.shape[1]} "
            f"mode={mode} scoring={list(sc)}",
            lambda: al.align_scores(qq, qql, tt, ttl, mode, *sc),
            lambda: al.align_scores_plain(qq, qql, tt, ttl, mode, *sc),
            reps=reps)
        row.update(full_work(qq, qql, tt, ttl))
        rows["full_score"].append(row)

    table = pair_inputs(rng, 64, 512, 1024, dev)
    strips = pair_inputs(rng, 32, 4608, 9216, dev)
    S = al.full_plan(512, 64).strip_rows
    one_row = pair_inputs(rng, 12, S + 1, S + 300, dev)
    one_row[1][:4] = S + 1                     # the last strip: one row
    ragged = pair_inputs(rng, 531, 300, 400, dev)
    for mode in (0, 1, 2):
        full_row(table, mode, scoring, 5)
    for pairs in (strips, one_row, ragged):
        for mode in (0, 1, 2):
            for sc in ((scoring, (2, -3, 1)) if pairs is strips
                       else (scoring,)):
                full_row(pairs, mode, sc, 1)
    del table, strips, one_row, ragged

    x = torch.from_numpy(rng.integers(-1000, 1000, (256, 1024))
                         .astype(np.int32)).to(dev)
    row = compare("int32_probe (256, 1024) n_iter=100",
                  lambda: probe.int32_probe(x, 100),
                  lambda: probe.int32_probe_plain(x, 100), reps=5)
    row.update(work=x.numel() * 100, unit="trips", bytes=8 * x.numel())
    rows["int32_probe"].append(row)
    del x
    torch.cuda.empty_cache()
    # The cluster path at the 50 kb reads' shape: the kernel table's row
    # for K2's cluster path.
    pairs = pairs_50k(rng, dev)
    k2_50k, k4_50k = band_rows_50k(pairs, scoring)
    rows["band_score"].append(k2_50k)
    rows["band_score_cluster"].insert(0, k2_50k)
    rows["band_parents"].append(k4_50k)
    rows["walk_parents"].append(walk_row_50k(pairs, scoring))
    del pairs
    torch.cuda.empty_cache()
    # The strip path at the 100 kb reads' realign shape: the kernel
    # table's rows for K2's and K4's strip path.
    k2_100k, k4_100k = band_rows_100k(pairs_100k(rng, dev, 2), scoring)
    rows["band_score"].append(k2_100k)
    rows["band_score_strip"].insert(0, k2_100k)
    rows["band_parents"].append(k4_100k)
    rows["band_parents_strip"].insert(0, k4_100k)
    rows["strip_card"] = dataclasses.asdict(bd.strip_card(dev))
    torch.cuda.empty_cache()
    # K2's "epochs" path past the card's w_strip: the kernel table's rows
    # (phase 2E adds the megabase read's realign pair).
    rows["band_score_epochs"] = band_rows_epochs(scoring, dev)
    # K1 on the match rows the 50 kb reads give it on the main path.
    f, r, cnt = chain_rows_50k(dev)[0]
    rows["lis_chain"].append(chain_row(
        f"lis_chain 50kb rows R={f.shape[0]} N={f.shape[1]}", f, r, cnt, 3))
    # K1's wide path: the rows of the ~150 kb read's fused call (the 196,608
    # bucket's base budget, 73,728) and of the ~250 kb read's largest call,
    # then a colinear row past 65,535.
    for run, what in ((0, "150kb"), (1, "250kb")):
        f, r, cnt = chain_rows_ultra(dev, run)[0]
        rows["lis_chain_wide"].append(chain_row(
            f"lis_chain_wide {what} rows R={f.shape[0]} N={f.shape[1]}", f,
            r, cnt, 3))
    rows["lis_chain_wide"].append(wide_chase_row(dev))
    # Past 2,097,152 matches: the rows of the 4.2 Mb read's fused call (a
    # few thousand matches in a budget of 2,359,296), then a colinear row of
    # 2,200,000, its prologue split from its DP by K1's measurement build.
    f, r, cnt = chain_rows_4mb(dev)[0]
    check(f.shape[1] == 2359296, f"the 4.2 Mb read's first K1 call has "
                                 f"N = {f.shape[1]}, not 2,359,296")
    rows["lis_chain_wide"].append(chain_row(
        f"lis_chain_wide 4.2Mb rows R={f.shape[0]} N={f.shape[1]}", f, r,
        cnt, 3))
    del f, r, cnt
    rows["lis_chain_wide"].append(wide_colinear_row(dev, chain_split))
    rows["cluster_occupancy"] = cluster_occupancy()
    return rows


def chain_row(name: str, f, r, cnt, reps: int) -> dict:
    """K1 against its plain version on one call's rows, with its plan
    (ops/chain.chain_plan) and its work (chain_work)."""
    from bioinfo1_tpu_torch.ops import chain as ch
    row = compare(name, lambda: ch.lis_chain(f, r, cnt),
                  lambda: ch.lis_chain_plain(f, r, cnt), reps=reps)
    row.update(dataclasses.asdict(ch.chain_plan(f.shape[1])))
    row.update(chain_work(f, r, cnt))
    return row


def wide_chase_row(dev) -> dict:
    """K1's wide path on chase_rows(WIDE_CHASE_N): the colinear row (lis
    and every chosen predecessor past 65,535 at its end, a chase of N - 1
    steps through global memory) against the plain version, and the flat
    row beside it (the same f and pair tests, no predecessor, no chase),
    held to its closed form and timed: chain - flat is the chase's time."""
    from bioinfo1_tpu_torch.ops import chain as ch
    N = WIDE_CHASE_N
    rows = chase_rows(N, dev)
    row = chain_row(f"lis_chain_wide colinear R=1 N={N}", *rows["chain"], 3)
    check(row["path"] == "wide", f"N = {N} is not on the wide path")
    got = ch.lis_chain(*rows["chain"])
    check(got.length.tolist() == [N], f"colinear row: length "
                                      f"{got.length.tolist()}, not {N}")
    flat = ch.lis_chain(*rows["flat"])
    check([getattr(flat, k).tolist() for k in ("length", "q_start", "q_end",
                                                "t_start", "t_end")]
          == [[1], [1], [1], [N], [N]],
          "flat row: not a chain of one match at j = 0")
    row["flat_ms"] = cuda_ms(lambda: ch.lis_chain(*rows["flat"]), 3)
    row["chase_ms"] = row["ms"] - row["flat_ms"]
    row["chase_ns_per_step"] = 1e6 * row["chase_ms"] / (N - 1)
    return row


def wide_colinear_row(dev, split) -> dict:
    """K1's wide path on a colinear row of WIDE_COLINEAR_N matches (f = r =
    1..N, q_lo past 65,535): held to its closed form (each match's unique
    best predecessor is the one before it, so length N from j = 0 to N -
    1; the O(N^2) plain version is out of reach), timed, and split by
    ``split`` (chain_profile_split) into prologue, DP and chase."""
    from bioinfo1_tpu_torch.ops import chain as ch
    N = WIDE_COLINEAR_N
    up = torch.arange(1, N + 1, dtype=torch.int32, device=dev)[None]
    cnt = torch.full((1,), N, dtype=torch.int32, device=dev)
    got = ch.lis_chain(up, up, cnt)
    ends = torch.tensor([1, N], dtype=torch.int32, device=dev)
    want = ch.ChainResult(cnt, ends[:1], ends[1:], ends[:1], ends[1:])
    err = max_abs_err(got, want)
    check(err == 0, f"colinear row of {N}: not its closed form")
    row = {"call": f"lis_chain_wide colinear R=1 N={N}",
           "ms": cuda_ms(lambda: ch.lis_chain(up, up, cnt), 2),
           "plain_ms": None, "max_abs_err": err, "against": "closed form"}
    row.update(dataclasses.asdict(ch.chain_plan(N)))
    check(row["path"] == "wide", f"N = {N} is not on the wide path")
    row.update(chain_work(up, up, cnt))
    row["profile"] = split(up, up, cnt, got)
    return row


def chain_profile_split(source: str = None, tag: str = "k1"):
    """Starts nvcc on K1's source alone (``source``: default csrc/
    lis_chain.cu) with BIOINFO1_CHAIN_PROFILE, into a library of its own
    under WORK, in the background; returns ``split(f, r, cnt, want)``,
    which waits for the build, runs that library's K1 once on one wide row
    and gives block 0's SM clocks by phase as ms of its globaltimer time:
    the prologue (chunk bounds, q_lo), the DP (cross phase, fold, serial
    scan, stores) and the end of the row (the chase), its outputs checked
    against ``want``.  Not the package's library: its launches count
    nowhere."""
    import ctypes
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import chain as ch
    src = source or os.path.join(build.CSRC, "lis_chain.cu")
    os.makedirs(WORK, exist_ok=True)
    lib_path = os.path.join(WORK, f"libchain_profile_{tag}.so")
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-DBIOINFO1_CHAIN_PROFILE",
         "-I", build.CSRC, "-shared", src, "-o", lib_path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    names = CHAIN_PROFILE_COUNTERS
    lib = []

    def split(f, r, cnt, want) -> dict:
        if not lib:
            _, err = proc.communicate()
            check(proc.returncode == 0, f"nvcc of K1's measurement build "
                                        f"failed: {err[-2000:]}")
            lib.append(ctypes.CDLL(lib_path))
            lib[0].bioinfo1_lis_chain.argtypes = build._SIGNATURES[
                "bioinfo1_lis_chain"]
            lib[0].bioinfo1_chain_profile.argtypes = [ctypes.c_void_p]
            for fn in (lib[0].bioinfo1_lis_chain,
                       lib[0].bioinfo1_chain_profile):
                fn.restype = ctypes.c_int
        R, N = f.shape
        check(R == 1 and ch.chain_plan(N).path == "wide",
              "the split takes one row on the wide path")
        n_pad = -(-N // ch.CHAIN_C) * ch.CHAIN_C
        packed = torch.empty((R, n_pad), dtype=torch.int64, device=f.device)
        prev = torch.empty((R, n_pad), dtype=torch.int32, device=f.device)
        q_lo = torch.empty((R, n_pad // ch.CHAIN_C), dtype=torch.int32,
                           device=f.device)
        out = torch.empty((5, R), dtype=torch.int32, device=f.device)
        buf = (ctypes.c_ulonglong * len(names))()
        torch.cuda.synchronize()
        check(lib[0].bioinfo1_chain_profile(ctypes.addressof(buf)) == 0,
              "bioinfo1_chain_profile failed")
        e = lib[0].bioinfo1_lis_chain(
            f.data_ptr(), r.data_ptr(), cnt.data_ptr(), R, N,
            packed.data_ptr(), prev.data_ptr(), q_lo.data_ptr(),
            out.data_ptr(), ch.CHAIN_PATHS.index("wide"), ch.CHAIN_THREADS,
            None)
        torch.cuda.synchronize()
        check(e == 0, f"K1's measurement build: CUDA error {e}")
        check(lib[0].bioinfo1_chain_profile(ctypes.addressof(buf)) == 0,
              "bioinfo1_chain_profile failed")
        got = dict(zip(names, buf))
        check(max_abs_err(ch.ChainResult(*out.unbind(0)), want) == 0,
              "K1's measurement build differs from K1")
        ms = got["ns"] / 1e6 / got["total"]     # per SM clock
        return {"prologue_ms": ms * got["prologue"],
                "dp_ms": ms * sum(got[k] for k in ("cross", "fold", "serial",
                                                   "store_barrier")),
                "chase_ms": ms * got["end_of_row"], "ms": got["ns"] / 1e6,
                "ghz": got["total"] / got["ns"], "clocks": got}

    return split


W_50K = 25088         # the 50 kb reads' band (7 CTAs of 448 threads)


def region_pairs(rng, dev, B: int, n: int, m: int, lens: tuple,
                 longer: int) -> list:
    """B ONT-profile reads of fragments of rng.integers(*lens) bases
    against their regions, ``longer`` bases past the fragment; (B, n) and
    (B, m) byte rows."""
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(*lens))
        tgt = sim.random_genome(ln + longer, rng)
        qry = sim.mutate_read(tgt[:ln], rng)[:n]
        qa[b, :len(qry)], ql[b] = qry, len(qry)
        ta[b, :len(tgt)], tl[b] = tgt, len(tgt)
    return [torch.from_numpy(x).to(dev) for x in (qa, ql, ta, tl)]


def pairs_50k(rng, dev, B: int = 11) -> list:
    """The shape the 50 kb reads give K2 / K4 / K5: B = 11 reads of ~46 kb
    against regions 1,500 bases longer, (B, n) = (11, 50000), m = 52000."""
    return region_pairs(rng, dev, B, 50000, 52000, (44000, 48000), 1500)


def band_rows_50k(pairs, scoring) -> list:
    """K2 and K4 on the cluster path at the 50 kb reads' shape (W_50K),
    held to the plain version and to the scratch kernel on the same
    inputs, with the scratch kernel's time beside the kernel's: the time
    the cluster path replaces."""
    from bioinfo1_tpu_torch.ops import band as bd
    q, ql, t, tl = pairs
    W, (B, n) = W_50K, q.shape
    m_eff = bd.band_shapes(n, t.shape[1], W)[2]
    out = []
    for parents in (False, True):
        def run(scratch=False, plain=False):
            fn = (bd.align_scores_banded_plain if plain
                  else bd.align_scores_banded)
            with band_plan_as(lambda planned: (
                    lambda W_, B_, p_, card=None: bd.scratch_plan(W_, p_))
                    if scratch else planned):
                return fn(q, ql, t, tl, *scoring, band=W, mode=0,
                          dash_free=True, want_parents=parents)
        err_fn = parents_err(ql, tl, m_eff) if parents else max_abs_err
        row, got = compare(
            f"band{'+parents' if parents else ''} W={W} B={B} n={n} mode=0 "
            "dash_free=True", run, lambda: run(plain=True), reps=1,
            err_fn=err_fn, keep=True)
        torch.cuda.empty_cache()
        err = err_fn(got, run(scratch=True))
        check(err == 0, f"cluster path differs from the scratch kernel at "
                        f"W={W}, n={n}, parents={parents}")
        del got
        torch.cuda.empty_cache()
        row.update(scratch_ms=cuda_ms(lambda: run(scratch=True), 1),
                   max_abs_err_vs_scratch=err,
                   **dataclasses.asdict(bd.band_plan(W, B, parents)))
        row.update(band_work(q, ql, t, tl, W, parents))
        out.append(row)
        torch.cuda.empty_cache()
    return out


def written_rows_err(a, b, q_lens, t_lens, n: int, m: int, W: int) -> int:
    """The number of parent bytes where two parent tensors differ in the
    rows each read's kernel writes (up to its last diagonal): the cells
    outside the matrix too."""
    from bioinfo1_tpu_torch.ops import band as bd
    _, _, m_eff, n_steps = bd.band_shapes(n, m, W)
    last = (q_lens.long() + t_lens.long().clamp(max=m_eff)).clamp(
        max=n_steps + 1)
    return max((int((a[:(d - 2) // 4 + 1, r] != b[:(d - 2) // 4 + 1, r])
                    .sum()) for r, d in enumerate(last.tolist()) if d >= 2),
               default=0)


def band_rows_100k(pairs, scoring) -> list:
    """K2 (B = 2) and K4 (B = 1, the -c chunk of a 100 kb read) on the
    strip path at the 100 kb reads' realign shape (W = 65,536), as the
    card plans them, held to the plain version on the same inputs: score
    and goals, and for K4 every parent byte of the rows it writes."""
    from bioinfo1_tpu_torch.ops import band as bd
    W = W_100K
    out = []
    for parents, B in ((False, 2), (True, 1)):
        q, ql, t, tl = (x[:B].contiguous() for x in pairs)
        n, m = q.shape[1], t.shape[1]
        plan = bd.band_plan(W, B, parents, bd.strip_card(q.device))
        check(plan.path == "strip", f"W={W}: the {plan.path} path")

        def run(plain=False):
            fn = (bd.align_scores_banded_plain if plain
                  else bd.align_scores_banded)
            return fn(q, ql, t, tl, *scoring, band=W, mode=0,
                      dash_free=True, want_parents=parents)
        m_eff = bd.band_shapes(n, m, W)[2]

        def err_fn(got, want):
            if not parents:
                return max_abs_err(got, want)
            return max(parents_err(ql, tl, m_eff)(got, want),
                       written_rows_err(got.parents, want.parents, ql, tl,
                                        n, m, W))
        row = compare(f"band{'+parents' if parents else ''} W={W} B={B} "
                      f"n={n} mode=0 dash_free=True", run,
                      lambda: run(plain=True), reps=1, err_fn=err_fn)
        row.update(dataclasses.asdict(plan))
        row.update(band_work(q, ql, t, tl, W, parents))
        out.append(row)
        torch.cuda.empty_cache()
    return out


def with_bound(row: dict, name: str) -> dict:
    """``row`` with its bound (bound) and time / bound."""
    row["bound_ms"], row["bound_by"] = bound(row, NEEDED_OPS[name])
    row["time_over_bound"] = row["ms"] / row["bound_ms"]
    return row


def paired_ms(runs: dict, reps: int = 1) -> dict:
    """ms of each of two calls, timed in turns (a, b, b, a): each one's
    two timings."""
    (a, fa), (b, fb) = runs.items()
    out = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        out[name].append(cuda_ms(fn, reps))
    return out


def band_rows_epochs(scoring, dev) -> list:
    """K2 on the "epochs" path (band_epoch_kernel): at W = W_PAST_STRIP, 2
    reads of ~8 kb, each mode, against the plain version and
    against the scratch kernel on the same inputs (against_scratch, timed
    too); then the strip trial's 8 reads of 100 kb at W = 65,536 forced
    onto it (epochs_past_cluster), held to the strip path as planned and
    timed beside it in turns: what the epochs cost against co-resident
    strips.  Each row with its bound and time / bound."""
    from bioinfo1_tpu_torch.ops import band as bd
    card = bd.strip_card(dev)
    out = []
    # 2 reads of ~7.6-8 kb against regions 300 bases longer: short enough
    # for the plain version and the scratch kernel at W_PAST_STRIP.
    q, ql, t, tl = region_pairs(np.random.default_rng(8), dev, 2, 8000,
                                8400, (7600, 8001), 300)
    W, (B, n) = W_PAST_STRIP, q.shape
    for mode in (0, 1, 2):
        def run(mode=mode):
            return bd.align_scores_banded(q, ql, t, tl, *scoring, band=W,
                                          mode=mode, dash_free=True)
        row, got = compare(
            f"band epochs W={W} B={B} n={n} mode={mode} dash_free=True",
            run, lambda mode=mode: bd.align_scores_banded_plain(
                q, ql, t, tl, *scoring, band=W, mode=mode, dash_free=True),
            reps=1, keep=True)
        plan = bd.band_plan(W, B, False, card)
        check(plan.path == "epochs", f"W={W}: the {plan.path} path")
        row.update(dataclasses.asdict(plan))
        row.update(band_work(q, ql, t, tl, W, False))
        against_scratch(row, run, max_abs_err, got, time_the_check=True)
        out.append(with_bound(row, "band_score_epochs"))
        torch.cuda.empty_cache()
    del q, ql, t, tl
    q, ql, t, tl = pairs_100k(np.random.default_rng(6), dev)
    W, (B, n) = W_100K, q.shape

    def run():
        return bd.align_scores_banded(q, ql, t, tl, *scoring, band=W, mode=0,
                                      dash_free=True)

    def epochs():
        with band_plan_as(epochs_past_cluster):
            return run()
    want, got = run(), epochs()
    err = max_abs_err(got, want)
    check(err == 0, f"W={W}: the epochs path differs from the strips "
                    f"(max abs err {err})")
    del want, got
    times = paired_ms({"epochs": epochs, "strip": run})
    row = {"call": f"band epochs vs strips W={W} B={B} n={n} mode=0 "
                   "dash_free=True", "ms": min(times["epochs"]),
           "plain_ms": None, "max_abs_err": err, "against": "strip path",
           "paired_ms": times, "strip_ms": min(times["strip"]),
           **dataclasses.asdict(bd.epoch_plan(W)),
           **band_work(q, ql, t, tl, W, False)}
    out.append(with_bound(row, "band_score_epochs"))
    del q, ql, t, tl
    torch.cuda.empty_cache()
    return out


def walk_work(codes, B: int) -> dict:
    """What a walk needs: its steps (one dependent parent-byte load each),
    the longest chain, and the bytes - the steps' parent bytes, the goals
    and the codes it writes."""
    from bioinfo1_tpu_torch.ops import trace as tr
    steps = (tr.unpack_codes(codes.cpu().numpy()) != tr.OP_DONE).sum(axis=0)
    return {"work": int(steps.sum()), "unit": "steps",
            "chain_steps": int(steps.max()),
            "bytes": int(steps.sum()) + 12 * B + codes.numel()}


def walk_row_50k(pairs, scoring, plain: bool = True) -> dict:
    """K5 on K4's cluster-path parents of the 50 kb reads' shape (W_50K;
    7 GB of parents): against the plain walk, or, without ``plain``,
    timed alone."""
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.ops import trace as tr
    q, ql, t, tl = pairs
    out = bd.align_scores_banded(q, ql, t, tl, *scoring, band=W_50K, mode=0,
                                 dash_free=True, want_parents=True)
    args = (out.parents, out.goal_i, out.goal_j, out.score, q, t, *scoring,
            0)
    name = f"walk W={W_50K} B={q.shape[0]} n={q.shape[1]} mode=0"
    if plain:
        row, codes = compare(name, lambda: tr.walk_parents(*args),
                             lambda: tr.walk_parents_plain(*args), reps=3,
                             keep=True)
    else:
        codes = tr.walk_parents(*args)
        torch.cuda.synchronize()
        row = {"call": name, "ms": cuda_ms(lambda: tr.walk_parents(*args),
                                           3)}
    row["parent_bytes"] = out.parents.numel()
    row.update(walk_work(codes, q.shape[0]))
    del out, args
    torch.cuda.empty_cache()
    return row


def parents_err_chunked(a, b, q_lens, t_lens, m_eff, rows: int = 256):
    """The number of cells inside the matrix where two parent tensors
    differ, ``ops/band.parent_cells`` taken over chunks of byte rows (the
    whole tensors would not expand at once)."""
    from bioinfo1_tpu_torch.ops import band as bd
    err = 0
    for r0 in range(0, a.shape[0], rows):
        ca, cb = (bd.parent_cells(x[r0:r0 + rows], q_lens, t_lens, m_eff,
                                  first_row=r0) for x in (a, b))
        err = max(err, int((ca != cb).sum()))
    return err


def cluster_occupancy() -> list:
    """cudaOccupancyMaxActiveClusters of the cluster path for 2-8 CTAs of
    512 threads: how many reads' clusters run at once, K2 and K4."""
    import ctypes
    from bioinfo1_tpu_torch.kernels import build
    lib = build.library()
    out = []
    for parents in (False, True):
        for c in range(2, 9):
            n = ctypes.c_int(0)
            err = lib.bioinfo1_band_cluster_occupancy(int(parents), 0, c, 512,
                                                      ctypes.byref(n))
            check(err == 0, f"cluster occupancy ({c} CTAs): CUDA error {err}")
            out.append({"parents": parents, "cluster": c, "threads": 512,
                        "clusters_at_once": n.value,
                        "ctas_at_once": n.value * c})
    return out


def walk_pairs(dev) -> list:
    """Phase 1's pairs of the kernel table's K4 / K5 rows: the generator
    replayed past K1's rows."""
    rng = np.random.default_rng(1)
    for R, N in CHAIN_SHAPES:
        chain_inputs(rng, R, N, torch.device("cpu"))
    return pair_inputs(rng, *WALK_PAIRS, dev)


def walk_chain(codes, b: int, gi: int, gj: int, S4: int, B: int,
               W: int) -> dict:
    """The parent bytes the walk of read ``b`` reads, replayed on the host
    from its packed codes: the steps, the distinct parent byte rows and
    32-byte sectors they touch, and how often a step reads another sector
    (another 128-byte line) than the step before it - the loads that can
    hit neither L1 nor a register of the previous step."""
    from bioinfo1_tpu_torch.ops import trace as tr
    c = tr.unpack_codes(codes)[:, b]
    c = c[c != tr.OP_DONE].astype(np.int64)
    steps = len(c)
    if not steps:
        return {"steps": 0}
    i = gi - np.concatenate([[0], np.cumsum((c == 0) | (c == 2))[:-1]])
    j = gj - np.concatenate([[0], np.cumsum((c == 0) | (c == 1))[:-1]])
    d = i + j
    row = np.clip(d - 2, 0, 4 * S4 - 1) >> 2
    lane = np.clip((j - i + W - (d & 1)) >> 1, 0, W - 1)
    addr = (row * B + b) * W + lane
    return {"steps": steps, "rows": len(np.unique(row)),
            "sectors": len(np.unique(addr >> 5)),
            "sector_changes": 1 + int((np.diff(addr >> 5) != 0).sum()),
            "line_changes": 1 + int((np.diff(addr >> 7) != 0).sum()),
            "lane_span": int(lane.max() - lane.min())}


def walk_cache_rows(dev, q, ql, t, tl) -> list:
    """K5 at the kernel table's shape (W = 256, global) with its parents
    out of L2 and in it: on all reads (the parent tensor far larger than
    the 50 MB L2) and on the first 32 (a tensor that fits), each timed
    cold (L2_FLUSH_BYTES written before every launch; the median of 5)
    and warm (after a launch that read the same parents).
    ``ns_per_step`` divides a launch by the longest chain's steps (every
    read walks at once); the longest chain's parent rows, sectors and
    sector changes come from ``walk_chain``."""
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.ops import trace as tr
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    rows = []
    for B in (q.shape[0], 32):
        qq, qql, tt, ttl = (x[:B].contiguous() for x in (q, ql, t, tl))
        out = bd.align_scores_banded(qq, qql, tt, ttl, 1, -1, -1, band=256,
                                     mode=0, dash_free=True,
                                     want_parents=True)
        args = (out.parents, out.goal_i, out.goal_j, out.score, qq, tt,
                1, -1, -1, 0)
        codes = tr.walk_parents(*args)
        for _ in range(5):      # the card's clocks up from idle first
            tr.walk_parents(*args)
        torch.cuda.synchronize()
        cold = []
        for rep in range(5):
            flush.fill_(rep)
            start.record()
            tr.walk_parents(*args)
            stop.record()
            stop.synchronize()
            cold.append(start.elapsed_time(stop))
        tr.walk_parents(*args)
        warm = cuda_ms(lambda: tr.walk_parents(*args), 5)
        packed = codes.cpu().numpy()
        steps = (tr.unpack_codes(packed) != tr.OP_DONE).sum(axis=0)
        b = int(steps.argmax())
        S4, _, W = out.parents.shape
        chain = walk_chain(packed, b, int(out.goal_i[b]),
                           int(out.goal_j[b]), S4, B, W)
        cold_ms = sorted(cold)[len(cold) // 2]
        rows.append({"call": f"walk W={W} B={B} n={q.shape[1]} mode=0",
                     "parent_bytes": out.parents.numel(),
                     "cold_ms": cold_ms, "cold_ms_each": cold,
                     "warm_ms": warm, "chain": chain,
                     "cold_ns_per_step": 1e6 * cold_ms / chain["steps"],
                     "warm_ns_per_step": 1e6 * warm / chain["steps"]})
        del out, args, codes
        torch.cuda.empty_cache()
    return rows


def phase_walk_trial(dev) -> dict:
    """K5 alone, for a comparison of two trees in one call (run this file
    from either tree's root): its cold / L2-warm rows (walk_cache_rows),
    its time on the parents of the 50 kb reads' cluster shape (W =
    25088, B = 11), the SASS census of its loops, and bench_torch's
    long-read rates (20 kb score-only and -c, 50 kb) with a -c pass of the
    20 kb reads under torch.profiler (device time by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import trace as tr
    from bioinfo1_tpu_torch.pipeline.mapper import MapperConfig
    import sass_census as sass
    res = {"phase": "1w",
           "walk_cache": walk_cache_rows(dev, *walk_pairs(dev))}
    torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    res["walk_50k"] = walk_row_50k(pairs_50k(rng, dev), (1, -1, -1),
                                   plain=False)
    torch.cuda.empty_cache()
    listing = build.sass()
    res["sass"] = {name: sass.cell_loops(listing, name)[:3]
                   for name in sass.functions(listing)
                   if "walk_parents" in name}
    genome = bench_torch.make_data(bench_torch.FULL)[0]
    mapper = bench_torch.make_product_mapper(genome, dev)
    res["longread"] = bench_torch.measure_longread(genome, mapper)
    recs20 = sim.simulate_reads(genome, bench_torch.FULL.long_a,
                                np.random.default_rng(bench_torch.SEED + 7))
    mapper.cfg = MapperConfig(output_cigar=True)
    before = tr.walk_parents.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.map_records(recs20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, top = device_time(prof)
    res["longread_20k_cigar_profiled"] = {
        "wall_s": wall, "device_busy_s": busy, "top_device": top,
        "walk_launches": tr.walk_parents.launches - before}
    return res


def chain_rows_50k(dev) -> list:
    """The match rows K1 gets on the main path from the 50 kb reads of
    phase 2L (longread_records): the inputs of every ``lis_chain`` call of
    one score-only ``Mapper.map_records`` run (the fused step's
    find_matches_combined rows of both strands, budget retries included),
    captured on the way in, largest match budget first."""
    genome, recs = longread_records()
    return chain_calls([("bench", genome)], recs, dev)


def chain_rows_ultra(dev, run: int = 0) -> list:
    """chain_rows_50k for a run of the second golden recipe (GOLDEN_ULTRA):
    the ~150 kb read's largest call is its fused call at the 196,608
    bucket's base budget, 73,728; the ~250 kb read's, the 262,144 bucket's
    98,304 doubled by an overflow retry: both K1's wide path."""
    from bioinfo1_tpu_torch.utils import golden
    pin = golden.load(GOLDEN_ULTRA)
    genome, recs = golden.records(pin["recipe"])
    return chain_calls([(pin["recipe"]["ref_name"], genome)],
                       golden.run_records(recs, pin["runs"][run]), dev)


def chain_rows_4mb(dev) -> list:
    """chain_rows_50k for GOLDEN_4MB's read of 4,200,000 bases: its first
    fused call asks K1 for the 6,291,456 bucket's base budget, 2,359,296."""
    from bioinfo1_tpu_torch.utils import golden
    pin = golden.load(GOLDEN_4MB)
    genome, recs = golden.records(pin["recipe"])
    return chain_calls([(pin["recipe"]["ref_name"], genome)],
                       golden.run_records(recs, pin["runs"][0]), dev)


def chain_calls(refs, recs, dev) -> list:
    """The inputs of every ``lis_chain`` call of one score-only
    ``Mapper.map_records`` run of ``recs`` on ``refs``, captured on the way
    in, largest match budget first."""
    from bioinfo1_tpu_torch.ops import chain as ch
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    mapper = Mapper(refs, MapperConfig(), device=dev)
    calls, real = [], ch.lis_chain

    def capture(f, r, cnt):
        calls.append(tuple(x.clone() for x in (f, r, cnt)))
        return real(f, r, cnt)

    # The wrapper counts on its module's name.
    capture.launches, capture.path_launches = 0, dict.fromkeys(
        ch.CHAIN_PATHS, 0)
    ch.lis_chain = capture
    try:
        mapper.map_records(recs)
    finally:
        ch.lis_chain = real
    del mapper
    torch.cuda.empty_cache()
    return sorted(calls, key=lambda c: (-c[0].shape[1], -c[0].shape[0]))


def chain_work(f, r, cnt) -> dict:
    """What a chain call needs: its window pairs (j < i with f_i - 5000 <
    f_j < f_i, the pairs whose r test decides anything; counted in numpy),
    all c (c - 1) / 2 pairs beside them, the longest row, and the bytes
    (the valid matches' f and r read once, the counts, five int32 outputs
    a row).  ``swept``: the pair tests of K1's cross phase, 32 columns
    against every match of chunks [q_lo, k) (ops/chain.chunk_q_lo; None
    on a tree without it)."""
    from bioinfo1_tpu_torch.ops import chain as ch
    q_lo_of = getattr(ch, "chunk_q_lo", None)
    fa, ca = f.cpu().numpy(), cnt.cpu().numpy().clip(0, f.shape[1])
    window, swept = 0, 0
    for b in range(fa.shape[0]):
        x = fa[b, :int(ca[b])].astype(np.int64)
        if q_lo_of is not None:
            q_lo = q_lo_of(x, len(x))
            swept += 32 * 32 * int((np.arange(len(q_lo)) - q_lo).sum())
        if len(x) < 2:
            continue
        if np.all(x[1:] >= x[:-1]):
            # sorted: the j < i with f_j in (f_i - 5000, f_i)
            lo = np.searchsorted(x, x - 4999, side="left")
            hi = np.searchsorted(x, x, side="left")
            window += int(np.clip(np.minimum(hi, np.arange(len(x)))
                                  - lo, 0, None).sum())
        else:
            window += sum(int(((x[:i] > x[i] - 5000) & (x[:i] < x[i])).sum())
                          for i in range(1, len(x)))
    c = ca.astype(np.int64)
    return {"work": window, "unit": "window pairs",
            "all_pairs": int((c * (c - 1) // 2).sum()),
            "swept": swept if q_lo_of is not None else None,
            "longest_row": int(c.max()) if len(c) else 0,
            "bytes": 8 * int(c.sum()) + 24 * len(c)}


def chase_rows(N: int, dev) -> dict:
    """Two rows of N matches that test the same pairs: "flat" (r falls as f
    rises: no predecessor, a chain of 1, no pointer chase) and "chain" (f =
    r = 1..N: every match extends the chain, a chase of N - 1 steps)."""
    up = np.arange(1, N + 1, dtype=np.int32)[None, :]
    cnt = torch.full((1,), N, dtype=torch.int32, device=dev)
    rows = {"flat": (up, up[:, ::-1].copy()), "chain": (up, up)}
    return {k: [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in v] + [cnt] for k, v in rows.items()}


def phase_chain_trial(dev) -> dict:
    """K1 alone, for a comparison of two trees in one call (run this file
    from either tree's root; it uses nothing that K1's wrapper did not
    have before its redesign): its time per match at R = 1 and R = 512 for
    N = 1536 (phase 1's rows, f spread over 20,000) and on the 50 kb
    reads' rows (chain_rows_50k: the largest call, and its longest row
    alone), the pointer chase's share (chase_rows at N = 1536 and at the
    50 kb budget), each against the plain version; for every threads-per-
    CTA choice the tree offers (ops/chain.CHAIN_THREADS, where it exists)
    and the SASS census of the kernel's loops."""
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import chain as ch
    import sass_census as sass
    listing = build.sass()
    if any("lis_chain_kernelILi" in n for n in sass.functions(listing)):
        census = sass.chain_loops(listing)
    else:                                   # the first design: one kernel
        census = sass.cell_loops(listing, "lis_chain_kernel")[:3]
    rng = np.random.default_rng(1)
    table = chain_inputs(rng, *CHAIN_SHAPES[0], dev)
    longest = int(table[2].argmax())
    shapes = {"R=512 N=1536": table,
              "R=1 N=1536": [x[longest:longest + 1].contiguous()
                             for x in table]}
    calls = chain_rows_50k(dev)
    f50, r50, c50 = calls[0]
    shapes[f"50kb R={f50.shape[0]} N={f50.shape[1]}"] = calls[0]
    b = int(c50.argmax())
    shapes[f"50kb R=1 N={f50.shape[1]}"] = [
        x[b:b + 1].contiguous() for x in calls[0]]
    for N in (1536, f50.shape[1]):
        for name, rows in chase_rows(N, dev).items():
            shapes[f"chase {name} N={N}"] = rows
    kept = getattr(ch, "CHAIN_THREADS", None)
    threads = (512, 256, 128) if kept is not None else (None,)
    profile = chain_profile_reader()
    rows = []
    try:
        for name, (f, r, cnt) in shapes.items():
            work = chain_work(f, r, cnt)
            want = ch.lis_chain_plain(f, r, cnt)
            for t in threads:
                if t is not None:
                    ch.CHAIN_THREADS = t
                got = ch.lis_chain(f, r, cnt)
                t0 = time.perf_counter()       # the clocks up from idle
                while time.perf_counter() - t0 < 0.2:
                    ch.lis_chain(f, r, cnt)
                    torch.cuda.synchronize()
                ms = cuda_ms(lambda: ch.lis_chain(f, r, cnt), 5)
                err = max_abs_err(got, want)
                check(err == 0, f"chain trial {name}: kernel differs from "
                                "its plain version")
                row = {"call": name, "threads": t, "ms": ms,
                       "us_per_match": 1e3 * ms / max(work["longest_row"], 1),
                       "ns_per_window_pair": 1e6 * ms / max(work["work"], 1),
                       "length_max": int(got.length.max()),
                       "max_abs_err": err, **work}
                if profile is not None and f.shape[0] == 1:
                    profile()
                    ch.lis_chain(f, r, cnt)
                    torch.cuda.synchronize()
                    row["profile"] = profile()
                rows.append(row)
    finally:
        if kept is not None:
            ch.CHAIN_THREADS = kept
    return {"phase": "1c", "rows": rows,
            "calls_50kb": [[list(c[0].shape), int(c[2].max())]
                           for c in calls], "sass": census}


# K1's measurement build's counters (csrc/lis_chain.cu g_chain_profile):
# SM clocks of block 0's row by phase, its total, its globaltimer ns, its
# chunks.
CHAIN_PROFILE_COUNTERS = ("prologue", "cross", "fold", "serial",
                          "store_barrier", "end_of_row", "total", "ns",
                          "chunks")


def chain_profile_reader():
    """With the measurement build of K1 (BIOINFO1_CHAIN_PROFILE among
    BIOINFO1_NVCC_DEFINES, set by --chain-profile), a function that reads
    and clears its counters: SM clocks by phase of block 0's row, its total
    clocks and globaltimer ns (their ratio is the SM clock) and chunks.
    Else None."""
    import ctypes
    from bioinfo1_tpu_torch.kernels import build
    if "-DBIOINFO1_CHAIN_PROFILE" not in build.nvcc_flags():
        return None
    fn = build.library().bioinfo1_chain_profile
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    names = CHAIN_PROFILE_COUNTERS

    def read():
        buf = (ctypes.c_ulonglong * len(names))()
        check(fn(ctypes.addressof(buf)) == 0, "bioinfo1_chain_profile failed")
        out = dict(zip(names, buf))
        out["ghz"] = out["total"] / out["ns"] if out["ns"] else None
        return out

    return read


def full_calls_g1(dev) -> list:
    """The inputs of every ``align_scores`` call (K3) of one score-only -g 1
    ``Mapper.map_records`` run on phase 2g's reads (the first 512 of phase
    2, fresh bands; no certificate, so K3 scores every bucket), captured on
    the way in: (pairs, mode, scoring), widest first."""
    from bioinfo1_tpu_torch.ops import align as al
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    _ref, _paths, recs, genome, _short = write_inputs()
    mapper = Mapper([("ecoli_like", genome)], MapperConfig(gap=1),
                    device=dev)
    calls, real = [], al.align_scores

    def capture(q, ql, t, tl, mode, match, mismatch, gap):
        calls.append(([x.clone() for x in (q, ql, t, tl)], mode,
                      (match, mismatch, gap)))
        return real(q, ql, t, tl, mode, match, mismatch, gap)

    capture.launches = 0        # the wrapper counts on its module's name
    al.align_scores = capture
    try:
        mapper.map_records(recs[:N_NOCERT_READS])
    finally:
        al.align_scores = real
    del mapper
    torch.cuda.empty_cache()
    return sorted(calls, key=lambda c: (-c[0][0].shape[1],
                                        -c[0][0].shape[0]))


def phase_full_trial(dev) -> dict:
    """K3 alone, for a comparison of two trees in one call (run this file
    from either tree's root; it uses nothing that K3's wrapper did not
    have before its redesign): its time at the kernel table's shape (B =
    64, n = 512, m = 1024), at the widest call of a -g 1 run like phase
    2g's (the 8 kb bucket's fused step, full_calls_g1) and on 16 reads of
    50 kb (n = 50,000, m = 52,000, gap 1), for every rows-per-thread
    choice the tree offers (ops/align.FULL_LPTS, where it exists), with
    its bound, the SASS integer instructions per swept cell, the plain
    version on the first two shapes (on the 50 kb reads the choices are
    held to each other), and a digest of each output to compare the trees
    by."""
    import hashlib
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import align as al
    listing = build.sass()
    redesigned = hasattr(al, "full_plan")
    lpts = al.FULL_LPTS if redesigned else (None,)
    kept = getattr(al, "FULL_LPT", None)
    issued = {lpt: full_issued(listing, 0, lpt or 0) for lpt in lpts}
    rng = np.random.default_rng(1)
    calls = full_calls_g1(dev)
    (pairs8, mode8, sc8) = calls[0]
    q8 = pairs8[0]
    shapes = [
        ("table B=64 n=512 m=1024", pair_inputs(rng, 64, 512, 1024, dev), 0,
         (1, -1, -1), 5, True),
        (f"8kb fused -g 1 B={q8.shape[0]} n={q8.shape[1]} "
         f"m={pairs8[2].shape[1]}", pairs8, mode8, sc8, 3, True),
        ("50kb B=16 n=50000 m=52000", pairs_50k(rng, dev, 16), 0, (1, -1, 1),
         1, False)]
    rows = []
    try:
        for name, pairs, mode, sc, reps, plain in shapes:
            def run():
                return al.align_scores(*pairs, mode, *sc)
            want, plain_ms = None, None
            if plain:
                t0 = time.perf_counter()
                want = al.align_scores_plain(*pairs, mode, *sc)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - t0)
            for lpt in lpts:
                if lpt is not None:
                    al.FULL_LPT = lpt
                got = run()
                torch.cuda.synchronize()
                if want is None:
                    want = got
                err = max_abs_err(got, want)
                check(err == 0, f"full trial {name} LPT {lpt}: the kernel "
                                "differs")
                ms = cuda_ms(run, reps)
                digest = hashlib.sha256(torch.stack(
                    [got.score, got.goal_i, got.goal_j]).cpu().numpy()
                    .tobytes()).hexdigest()[:16]
                row = {"call": name, "mode": mode, "scoring": list(sc),
                       "lpt": lpt, "ms": ms, "plain_ms": plain_ms,
                       "max_abs_err": err, "digest": digest,
                       **full_work(*pairs)}
                row["bound_ms"], row["bound_by"] = bound(
                    row, NEEDED_OPS["full_score"])
                row["int_ops_per_unit"] = issued[lpt]
                row["issued_over_needed"] = (
                    issued[lpt] * row["swept"]
                    / (NEEDED_OPS["full_score"] * row["work"]))
                rows.append(row)
            del want
            torch.cuda.empty_cache()
    finally:
        if kept is not None:
            al.FULL_LPT = kept
    return {"phase": "1f", "redesigned": redesigned, "rows": rows,
            "calls_g1": [[list(c[0][0].shape), c[0][2].shape[1], c[1]]
                         for c in calls]}


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
    its own SASS: for K1 the integer instructions of its cross loop per pair
    (the shared path's, and the wide path's for its own entry; of its serial
    loop per step, on each storage path), for K3 those
    of its interior pair loop per swept cell (global, the rows per thread of
    ops/align.FULL_LPT), per step for K5 (global mode's
    step loop), per trip (its add and max instructions) for K6.  For K2
    and K4 the kernel that serves the table's row (W = 256, global,
    dash_free), and the cluster path's at the 50 kb reads' W = 25088: the
    integer instructions of its interior pair loop over the 2 * LPT cells
    of a trip.  Reported beside NEEDED_OPS; no bound uses it."""
    import sass_census as sass
    from bioinfo1_tpu_torch.ops import band as bd

    def band(parents, W=256, B=256):
        plan = bd.band_plan(W, B, parents)
        return sass.band_interior_loop(listing,
                                       sass.plan_needle(plan, parents),
                                       plan.lpt)["int_per_cell"]

    chain = sass.chain_loops(listing)
    return {"lis_chain": chain["shared"]["cross"]["int_per_pair"],
            "lis_chain_wide": chain["wide"]["cross"]["int_per_pair"],
            "lis_chain_serial_step": {
                path: loops["serial"]["int_per_step"]
                for path, loops in chain.items()},
            "band_score": band(False),
            "band_score_cluster": band(False, 25088, 11),
            "band_parents_cluster": band(True, 25088, 11),
            "band_score_strip": band(False, W_100K, 2),
            "band_score_epochs": band(False, W_PAST_STRIP, 2),
            "band_parents_strip": band(True, W_100K, 1),
            "band_parents": band(True),
            "full_score": full_issued(listing),
            "walk_parents": sass.walk_step_loop(listing)["int_per_step"],
            "int32_probe":
                bench_torch.probe_census(listing)["issued_per_trip"]}


def full_issued(listing: str, mode: int = 0, lpt: int = 0):
    """K3's integer instructions per swept cell: its interior pair loop's
    (sass_census.full_interior_loop) at ``lpt`` rows a thread (0:
    ops/align.FULL_LPT); on a tree whose K3 is one kernel without strips,
    its largest innermost loop's per swept lane."""
    import sass_census as sass
    from bioinfo1_tpu_torch.ops import align as al
    if not hasattr(al, "full_plan"):
        return sass.cell_loops(listing, "full_score_kernel")[0][
            "by_kind"].get("int", 0)
    return sass.full_interior_loop(listing, mode,
                                   lpt or al.FULL_LPT)["int_per_cell"]


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
    for n in sorted({N_READS, N_CIGAR_MODE_READS, N_STAGED_READS,
                     N_CPU_READS, N_CPU_LOCAL_READS, N_NOCERT_READS,
                     N_NOCERT_LOCAL_READS}):
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


class _PathCount:
    """The launches of one path of a wrapper that counts them by path
    (``path_launches``: ops/band.band_plan's, K2 and K4 together, the
    score-only runs launching K2 alone; ops/chain.chain_plan's), read and
    reset like a wrapper's count: ``launches``."""

    def __init__(self, wrapper, path: str):
        self.wrapper, self.path = wrapper, path

    @property
    def launches(self) -> int:
        return self.wrapper.path_launches[self.path]

    @launches.setter
    def launches(self, n: int) -> None:
        self.wrapper.path_launches[self.path] = n


def launch_counters() -> dict:
    """Kernel name -> (wrapper, attribute) holding its launch count."""
    from bioinfo1_tpu_torch.ops import align as al
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.ops import chain as ch
    from bioinfo1_tpu_torch.ops import probe
    from bioinfo1_tpu_torch.ops import trace as tr
    band = bd.align_scores_banded
    return {"int32_probe": (probe.int32_probe, "launches"),
            "lis_chain": (ch.lis_chain, "launches"),
            "lis_chain_wide": (_PathCount(ch.lis_chain, "wide"), "launches"),
            "band_score": (band, "launches"),
            "band_score_cluster": (_PathCount(band, "cluster"), "launches"),
            # K2 and K4 on the strip path together: a score-only run
            # launches K2 alone there, a -c run K4 alone (phase 2U).
            "band_score_strip": (_PathCount(band, "strip"), "launches"),
            "band_score_epochs": (_PathCount(band, "epochs"), "launches"),
            "band_parents_strip": (_PathCount(band, "strip"), "launches"),
            "full_score": (al.align_scores, "launches"),
            "band_parents": (band, "parent_launches"),
            "walk_parents": (tr.walk_parents, "launches")}


def reset_launches() -> dict:
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.ops import chain as ch
    build.launches_by_device.clear()
    counters = launch_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    for counts in (bd.align_scores_banded.path_launches,
                   ch.lis_chain.path_launches):
        for path in counts:
            counts[path] = 0
    return counters


def run_cli(ref, reads, recs, flags, out_name: str, must_launch,
            min_frac: float = 0.9) -> tuple:
    """One GPU CLI run with --profile, the kernel counts set to 0 just
    before it and read just after; checks rc 0, that no batch raised, the
    kernels in ``must_launch`` and that >= ``min_frac`` of reads >= 2 kb
    mapped."""
    from bioinfo1_tpu_torch import cli
    from bioinfo1_tpu_torch.kernels import build
    out = os.path.join(WORK, out_name)
    err = io.StringIO()
    counters = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(flags + [ref, reads, "-o", out, "--profile"], stderr=err)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: getattr(w, a) for k, (w, a) in counters.items()}
    by_device = dict(build.launches_by_device)
    sys.stderr.write(err.getvalue())
    check(rc == 0, f"cli.main {flags} returned {rc}")
    prof = parse_profile(err.getvalue())
    check(prof["mapper"]["faults"] == 0,
          f"{flags}: {prof['mapper']['faults']} batches raised")
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
            "launches": launches, "launches_by_device": by_device,
            "peak_bytes": peak, "stages_s": prof["stages_s"],
            "mapper": prof["mapper"]}, lines


def golden_kernels(flags) -> tuple:
    """The kernels a golden run must launch: K1, K4 and K5 under -c (the
    staged host path too), K1 and K3 without a certificate (-g 1), else
    K1, K2 and K3 (the recipe has a band-0 bucket)."""
    if "-c" in flags:
        return ("lis_chain", "band_parents", "walk_parents")
    if "-g" in flags:
        return ("lis_chain", "full_score")
    return ("lis_chain", "band_score", "full_score")


def phase_golden() -> dict:
    """Phase 2a: the pinned golden workload (tests/torch_golden.json,
    bioinfo1_tpu_torch/utils/golden.py) on the card.
    ``bioinfo1_tpu_torch.map_all`` with no device argument must run on the
    card and give the default run's pinned PAF; then each of the CLI's
    runs must print its pinned PAF.  Kernel counts are set to 0 just before
    each and read just after: its kernels must have launched, and no batch
    may have raised."""
    import bioinfo1_tpu_torch as port
    from bioinfo1_tpu_torch import cli
    from bioinfo1_tpu_torch.utils import golden
    from bioinfo1_tpu_torch.utils.runtime import resolve_device
    pinned = golden.load(GOLDEN)
    recipe = pinned["recipe"]
    ref, reads = golden.write_inputs(recipe, os.path.join(WORK, "golden"))
    genome, recs = golden.records(recipe)
    check(resolve_device().type == "cuda", "map_all would not run on the card")
    rows = []
    counters = reset_launches()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        lines = port.map_all([(recipe["ref_name"], genome)], recs,
                             port.MapperConfig())
    torch.cuda.synchronize()
    (want,) = [r["sha256"] for r in pinned["runs"]
               if r["flags"] == ["-a", "global"]]
    rows.append({"run": "map_all", "flags": [], "wall_s":
                 time.perf_counter() - t0, "launches": {
                     k: getattr(w, a) for k, (w, a) in counters.items()},
                 "sha256": golden.sha256("".join(f"{x}\n" for x in lines)),
                 "want": want, "stderr": err.getvalue()[-2000:]})
    check("Exception during Align" not in err.getvalue(),
          f"map_all: a batch raised: {err.getvalue()[-2000:]}")
    for run in pinned["runs"]:
        counters = reset_launches()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        rc = cli.main(run["flags"] + [ref, reads, "--profile"], stdout=out,
                      stderr=err)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"golden {run['flags']}: rc {rc}: "
              f"{err.getvalue()[-2000:]}")
        mapper = parse_profile(err.getvalue())["mapper"]
        check(mapper["faults"] == 0,
              f"golden {run['flags']}: {mapper['faults']} batches raised")
        rows.append({"run": run["name"], "flags": run["flags"],
                     "wall_s": wall, "launches": {
                         k: getattr(w, a) for k, (w, a) in counters.items()},
                     "sha256": golden.sha256(out.getvalue()),
                     "want": run["sha256"], "mapper": mapper})
    for row in rows:
        for k in golden_kernels(row["flags"]):
            check(row["launches"][k] >= 1,
                  f"golden {row['run']}: kernel {k} never launched")
        check(row["sha256"] == row["want"],
              f"golden {row['run']}: the PAF's sha256 {row['sha256']} is "
              f"not the pinned {row['want']}")
    launches = {k: sum(r["launches"][k] for r in rows)
                for k in rows[0]["launches"]}
    return {"phase": "2a", "reads": len(recs), "runs": rows,
            "launches": launches, "pinned": True}


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


def phase_nocert(ref, paths, recs) -> tuple:
    """Score-only where no exactness certificate exists (gap > 0): every
    bucket's band is 0, so the fused step scores with K3 and no read is
    rerouted to a realign pass; K2 must not launch."""
    runs, lines = [], {}
    for key, flags, n in (("g1", ["-g", "1"], N_NOCERT_READS),
                          ("a_local_g1", ["-a", "local", "-g", "1"],
                           N_NOCERT_LOCAL_READS)):
        row, out = run_cli(ref, paths[n], recs[:n], flags, f"gpu_{key}.paf",
                           ("lis_chain", "full_score"))
        m = row["mapper"]
        check(row["launches"]["band_score"] == 0,
              f"{flags}: K2 launched without a certificate")
        check(m["realign_batches"] == 0, f"{flags}: a realign pass ran")
        check(m["t_fused_s"] > 0, f"{flags}: no fused batch ran")
        del row["phase"]
        runs.append(row)
        lines[key] = out
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    return {"phase": "2g", "runs": runs, "launches": launches}, lines


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


SCORE_AND_C = (("score", [], {}, ("lis_chain", "band_score", "full_score")),
               ("c", ["-c"], {"output_cigar": True},
                ("lis_chain", "band_parents", "walk_parents")))


@contextlib.contextmanager
def env_set(**values):
    """The environment variables ``values`` set inside the block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def paired_passes(name: str, mappers: dict, recs, want, kernels) -> dict:
    """Two in-process mappers of one card on the same reads, the reference
    ``base`` and the ``test`` one (``mappers`` in that order).  First batch
    by batch (chunks of 512 reads, no batch in flight beside another, so
    both start each batch from the same bands): the results and every
    counter but the timings must be equal.  Then four map_records passes on
    the adapted bands, base, test, test, base: each PAF must equal ``want``
    byte for byte.  The kernel counts are set to 0 just before the test
    mapper's first pass and read just after it; each of ``kernels`` must
    have launched.  No batch may raise (``faults``).  ``dealt``: the
    batches each entry of the test mapper was dealt in the passes."""
    from bioinfo1_tpu_torch.kernels import build
    (base, _), (test, tested) = mappers.items()
    seqs = [s for _, s in recs]
    row = {}
    batchwise = {}
    for how, mapper in mappers.items():
        mapper.device_index()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = [mapper.map_batch(seqs[o:o + 512])
                   for o in range(0, len(seqs), 512)]
        torch.cuda.synchronize()
        row[f"{how}_batchwise_reads_per_s"] = (
            len(seqs) / (time.perf_counter() - t0))
        batchwise[how] = (results, {
            k: v for k, v in mapper.counters.as_dict().items()
            if not k.startswith("t_")})
    check(batchwise[base] == batchwise[test],
          f"{name}: batch by batch, the {test} mapper's results or counters "
          f"differ from the {base} mapper's")
    dealt = list(tested.devices.batches)
    for i, how in enumerate((base, test, test, base)):
        if i == 1:
            counters = reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = mappers[how].map_records(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if i == 1:
            row["launches"] = {k: getattr(w, a)
                               for k, (w, a) in counters.items()}
        check(lines == want, f"{name} pass {i} ({how}): the PAF differs "
              "from the CLI run's")
        row.setdefault(f"{how}_reads_per_s", []).append(len(recs) / wall)
    for how, mapper in mappers.items():
        check(mapper.counters.faults == 0, f"{name}: "
              f"{mapper.counters.faults} batches of the {how} mapper raised")
    for k in kernels:
        check(row["launches"][k] >= 1, f"{name}: kernel {k} never launched")
    row.update(dealt=[b - d for b, d in zip(tested.devices.batches, dealt)],
               paf_lines=len(want), byte_identical=True,
               mapper=tested.counters.as_dict(),
               batchwise_counters=batchwise[test][1],
               launches_by_device=dict(build.launches_by_device),
               **{f"{test}_over_{base}_median": (
                   statistics.median(row[f"{test}_reads_per_s"])
                   / statistics.median(row[f"{base}_reads_per_s"]))})
    return row


def phase_split(genome: str, recs, cli: dict) -> dict:
    """Batches dealt to two streams of cuda:0 (parallel/shard.py) with one
    index copy, in-process on phase 2's reads, score-only and then -c,
    beside a one-entry mapper (``paired_passes``; both entries must be
    dealt batches, and the index must not be copied).  ``cli`` maps
    "score" and "c" to the CLI run of the same reads (phase 2, phase 2c's
    -c run): its PAF lines and its row."""
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    dev = torch.device("cuda", 0)
    runs = {}
    for key, _flags, cfg, kernels in SCORE_AND_C:
        want, cli_row = cli[key]
        mappers = {how: Mapper([("ecoli_like", genome)], MapperConfig(**cfg),
                               devices=devices)
                   for how, devices in (("one", [dev]), ("two", [dev, dev]))}
        row = paired_passes(f"split {key}", mappers, recs, want, kernels)
        check(min(row["dealt"]) >= 1
              and len(mappers["two"]._device_index) == 1,
              f"split {key}: an entry was dealt no batch, or the index was "
              "copied")
        row.update(reads=len(recs),
                   cli_reads_per_s_map=cli_row["reads_per_s_map"])
        runs[key] = row
        del mappers
        torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["score"]["launches"]}
    return {"phase": "2d", "devices": ["cuda:0", "cuda:0"], "runs": runs,
            "launches": launches}


def shard_bytes(index) -> list:
    """Bytes of each shard's lookup arrays (its ref_bytes apart)."""
    return [bench_torch.lookup_bytes(s) for s in index.shards]


def phase_shard(genome: str, recs, cli: dict) -> dict:
    """The hash-range-sharded index (parallel/shard.shard_index) on two
    entries of cuda:0 - two shards, two batch streams, the card's lookup
    stream - in-process on phase 2's reads, score-only and then -c, beside
    a replicated two-entry mapper (phase 2x, ``paired_passes``: replicated
    the base, sharded the test).  Both shards must have served lookups
    (``ShardedIndex.served``: the query slots each found).  Each shard's
    bytes, both mappers' index bytes and the card's peak memory (both
    indexes resident) go in the row.  ``cli`` as for ``phase_split``."""
    from bioinfo1_tpu_torch.pipeline import device_map as dm
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    dev = torch.device("cuda", 0)
    runs = {}
    for key, _flags, cfg, kernels in SCORE_AND_C:
        want, cli_row = cli[key]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        mappers, index_bytes = {}, {}
        for how, shard in (("rep", "0"), ("shard", "1")):
            mappers[how] = Mapper([("ecoli_like", genome)],
                                  MapperConfig(**cfg), devices=[dev, dev])
            before = torch.cuda.memory_allocated(dev)
            with env_set(BIOINFO1_INDEX_SHARD=shard):
                index = mappers[how].device_index()
            torch.cuda.synchronize()
            index_bytes[how] = torch.cuda.memory_allocated(dev) - before
            check(isinstance(index, dm.ShardedIndex) == (how == "shard"),
                  f"shard {key}: BIOINFO1_INDEX_SHARD={shard} gave a "
                  f"{type(index).__name__}")
        check(len(index.shards) == 2 and index.streams[0] is not None
              and index.streams[0] is index.streams[1],
              f"shard {key}: not two shards on one lookup stream")
        row = paired_passes(f"shard {key}", mappers, recs, want, kernels)
        served = [int(n) for n in index.served]
        check(min(served) > 0, f"shard {key}: a shard served no lookup "
              f"({served})")
        row.update(reads=len(recs),
                   cli_reads_per_s_map=cli_row["reads_per_s_map"],
                   index_bytes=index_bytes, shard_bytes=shard_bytes(index),
                   ref_bytes=index.ref_bytes.nbytes,
                   shard_range=index.shards[0].shard_range, served=served,
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
        runs[key] = row
        del mappers, index
        torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["score"]["launches"]}
    return {"phase": "2x", "devices": ["cuda:0", "cuda:0"], "runs": runs,
            "launches": launches}


def cli_runs(cards, ref, reads, recs, flags, key, kernels, variants):
    """The CLI once per variant (name -> (extra flags, env vars)), each
    card's peak memory measured; every PAF must equal the first's.
    Returns ({variant: row}, the PAF lines)."""
    out, first = {}, None
    for how, (extra, env) in variants.items():
        torch.cuda.empty_cache()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        with env_set(**env):
            row, lines = run_cli(ref, reads, recs, flags + extra,
                                 f"{how}_{key}.paf", kernels)
        row["peak_bytes"] = [torch.cuda.max_memory_allocated(d)
                             for d in cards]
        row["env"] = env
        first = first if first is not None else lines
        check(lines == first, f"{flags + extra} {env}: the PAF differs "
              "from the first variant's")
        out[how] = row
    return out, first


def launched_on_every_card(row, cards, what: str) -> None:
    check(all(row["launches_by_device"].get(d.index, 0) >= 1
              for d in cards),
          f"{what}: a card launched nothing ({row['launches_by_device']})")


def interleaved(name: str, mappers: dict, recs, want, cards) -> dict:
    """Two in-process mappers over the cards (``mappers``: base, then
    test): a pass each on fresh bands (every card's first launches), then
    timed passes on adapted bands in the order base, test, test, base,
    base, test, each PAF ``want``; reads/s of each, no batch raised."""
    (base, _), (test, _) = mappers.items()
    row = {"byte_identical": True}
    for how, mapper in mappers.items():
        mapper.device_index()
        check(mapper.map_records(recs) == want,
              f"{name} {how}: the fresh pass's PAF differs")
    for how in (base, test, test, base, base, test):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = mappers[how].map_records(recs)
        for d in cards:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        check(lines == want, f"{name} {how}: the PAF differs")
        row.setdefault(f"{how}_reads_per_s", []).append(len(recs) / wall)
    for how, mapper in mappers.items():
        check(mapper.counters.faults == 0, f"{name}: "
              f"{mapper.counters.faults} batches of the {how} mapper raised")
        row[f"{how}_mapper"] = mapper.counters.as_dict()
    row[f"{test}_over_{base}_median"] = (
        statistics.median(row[f"{test}_reads_per_s"])
        / statistics.median(row[f"{base}_reads_per_s"]))
    return row


def phase_split_trial() -> dict:
    """Batches dealt to every visible card against one card (phase 2m), on
    phase 2's inputs, score-only and -c.  The CLI with --devices 1 and then
    --devices 0: byte-identical PAFs, no batch raised, kernels launched on
    card 0 alone and then on every card, each card holding its index copy.
    Then in-process a one-card and an all-card mapper (``interleaved``)."""
    from bioinfo1_tpu_torch.parallel import shard as ps
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    dev = torch.device("cuda", 0)
    cards = ps.local_devices(dev)
    check(len(cards) >= 2, f"--split-trial needs >= 2 cards ({cards})")
    ref, paths, recs, genome, _short = write_inputs()
    runs = {}
    for key, flags, cfg, kernels in SCORE_AND_C:
        cli, want = cli_runs(cards, ref, paths[N_READS], recs, flags, key,
                             kernels, {"one": (["--devices", "1"], {}),
                                       "all": (["--devices", "0"], {})})
        check(set(cli["one"]["launches_by_device"]) == {0},
              f"{flags} --devices 1 launched on "
              f"{cli['one']['launches_by_device']}")
        launched_on_every_card(cli["all"], cards, f"{flags} --devices 0")
        peak = cli["all"]["peak_bytes"]
        check(min(peak) > 1 << 30, f"{flags}: a card held no index copy "
              f"(peak bytes {peak})")
        torch.cuda.empty_cache()
        mappers = {how: Mapper([("ecoli_like", genome)], MapperConfig(**cfg),
                               devices=devices)
                   for how, devices in (("one", [dev]), ("all", cards))}
        row = interleaved(key, mappers, recs, want, cards)
        row.update(one_cli=cli["one"], all_cli=cli["all"], peak_bytes=peak,
                   dealt=mappers["all"].devices.batches)
        runs[key] = row
        del mappers
        torch.cuda.empty_cache()
    return {"phase": "2m", "cards": [str(d) for d in cards], "runs": runs}


def big_genome_inputs(genome_mb: int):
    """An N Mb random genome and 2,048 ONT-profile reads of 2/4/8 kb from
    it (six batches: every card of four is dealt one), written under WORK;
    returns (ref, reads, recs)."""
    rng = np.random.default_rng(GENOME_SEED + 2)
    genome = sim.random_genome(genome_mb * 1_000_000, rng)
    recs = sim.simulate_reads(genome, [(2000, 4000, 8000)[i % 3]
                                       for i in range(N_READS)], rng)
    ref = os.path.join(WORK, f"ref_{genome_mb}mb.fa")
    g = genome.tobytes().decode("latin1")
    with open(ref, "w") as fh:
        fh.write(">big\n")
        for i in range(0, len(g), 80):
            fh.write(g[i:i + 80] + "\n")
    reads = os.path.join(WORK, f"reads_{genome_mb}mb.fq")
    with open(reads, "w") as fh:
        for name, s in recs:
            fh.write(f"@{name}\n{s}\n+\n{'5' * len(s)}\n")
    return ref, reads, recs


def phase_shard_trial() -> dict:
    """The sharded index over every visible card against the replicated one
    (phase 2y), on phase 2's inputs, score-only and -c.  The CLI with
    --devices 0 under BIOINFO1_INDEX_SHARD=0 and then =1: byte-identical
    PAFs, no batch raised, kernels launched on every card, each card's
    peak memory.  Then in-process a replicated and a sharded all-card
    mapper (``interleaved``); the query slots each shard served."""
    from bioinfo1_tpu_torch.parallel import shard as ps
    from bioinfo1_tpu_torch.pipeline import device_map as dm
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    cards = ps.local_devices(torch.device("cuda", 0))
    check(len(cards) >= 2, f"--shard-trial needs >= 2 cards ({cards})")
    ref, paths, recs, genome, _short = write_inputs()
    runs = {}
    for key, flags, cfg, kernels in SCORE_AND_C:
        cli, want = cli_runs(
            cards, ref, paths[N_READS], recs, flags, key, kernels,
            {how: (["--devices", "0"], {"BIOINFO1_INDEX_SHARD": shard})
             for how, shard in (("rep", "0"), ("shard", "1"))})
        for how in cli:
            launched_on_every_card(cli[how], cards, f"{flags} {how}")
        torch.cuda.empty_cache()
        mappers = {}
        for how, shard in (("rep", "0"), ("shard", "1")):
            mappers[how] = Mapper([("ecoli_like", genome)],
                                  MapperConfig(**cfg), devices=cards)
            with env_set(BIOINFO1_INDEX_SHARD=shard):
                mappers[how].device_index()
        index = mappers["shard"].device_index()
        check(isinstance(index, dm.ShardedIndex)
              and len(index.shards) == len(cards), f"{key}: not sharded")
        row = interleaved(key, mappers, recs, want, cards)
        served = [int(n) for n in index.served]
        check(min(served) > 0, f"{key}: a shard served no lookup {served}")
        row.update(cli=cli, shard_bytes=shard_bytes(index), served=served)
        runs[key] = row
        del mappers, index
        torch.cuda.empty_cache()
    return {"phase": "2y", "cards": [str(d) for d in cards], "runs": runs}


def phase_shard_big(genome_mb: int) -> dict:
    """--shard-trial --genome-mb N (phase 2z): the CLI with --devices 0
    (score-only) on an N Mb genome, replicated against
    BIOINFO1_INDEX_SHARD=auto with BIOINFO1_INDEX_BUDGET=1e9, so that auto
    itself shards: the PAFs byte-identical, every card launched, and each
    card's peak memory must drop by more than 2 GB."""
    from bioinfo1_tpu_torch.parallel import shard as ps
    cards = ps.local_devices(torch.device("cuda", 0))
    t0 = time.perf_counter()
    ref, reads, recs = big_genome_inputs(genome_mb)
    inputs_s = time.perf_counter() - t0
    cli, _ = cli_runs(cards, ref, reads, recs, ["--devices", "0"], "big",
                      ("lis_chain", "band_score"),
                      {"rep": ([], {"BIOINFO1_INDEX_SHARD": "0"}),
                       "auto": ([], {"BIOINFO1_INDEX_SHARD": "auto",
                                     "BIOINFO1_INDEX_BUDGET": "1e9"})})
    for how in cli:
        launched_on_every_card(cli[how], cards, f"--genome-mb {how}")
    rep, auto = cli["rep"]["peak_bytes"], cli["auto"]["peak_bytes"]
    check(all(a + (2 << 30) < r for r, a in zip(rep, auto)),
          f"--genome-mb {genome_mb}: auto did not shard (peak bytes a card "
          f"{rep} replicated, {auto} under auto)")
    return {"phase": "2z", "genome_mb": genome_mb, "inputs_s": inputs_s,
            "cards": [str(d) for d in cards], "cli": cli}


# ---- phase 2p / --process-trial: several CLI processes --------------------

class _Tee(io.StringIO):
    """Keeps what is written and passes it on to the real stderr: a peer
    failure ends the process by os._exit before anything is read back."""

    def write(self, s):
        sys.stderr.write(s)
        return super().write(s)

    def flush(self):
        sys.stderr.flush()


def process_worker(argv) -> int:
    """``--process-worker OUT [--hold] -- CLI ARGS``: one process of a
    multi-process run (the JAX_* variables are in its environment) through
    cli.main in-process with --profile, the kernel counts set to 0 just
    before; writes OUT, one JSON object: rc, process index, launches by
    kernel and by device, the --profile stages and counters (the mapper's
    ``faults``), each visible card's peak memory.  ``--hold`` holds
    Mapper.map_records_iter after its first yield (a batch checkpointed,
    heartbeats going on) until the process is killed."""
    from bioinfo1_tpu_torch import cli
    from bioinfo1_tpu_torch.kernels import build
    cut = argv.index("--")
    out_path = argv[argv.index("--process-worker") + 1]
    if "--hold" in argv[:cut]:
        from bioinfo1_tpu_torch.pipeline import mapper
        real = mapper.Mapper.map_records_iter

        def held(self, *args, **kwargs):
            it = real(self, *args, **kwargs)
            yield next(it)
            threading.Event().wait()

        mapper.Mapper.map_records_iter = held
    counters = reset_launches()
    err = _Tee()
    rc = cli.main(argv[cut + 1:] + ["--profile"], stderr=err)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    row = {"rc": rc, "pid": int(os.environ["JAX_PROCESS_ID"]),
           "launches": {k: getattr(w, a) for k, (w, a) in counters.items()},
           "launches_by_device": dict(build.launches_by_device),
           "peak_bytes": [torch.cuda.max_memory_allocated(d)
                          for d in range(torch.cuda.device_count())]}
    if rc == 0:
        row.update(parse_profile(err.getvalue()))
    with open(out_path, "w") as fh:
        json.dump(row, fh)
    return rc


def start_processes(n: int, args, name: str, env_of, hold=()) -> list:
    """n ``--process-worker`` processes of this file under one coordinator
    address and merge port (``bench_torch.start_processes``); ``env_of(p)``
    adds variables (CUDA_VISIBLE_DEVICES), processes in ``hold`` hold after
    their first batch.  Returns [(Popen, files base)]; stdout and stderr go
    to the base's .out / .err."""
    def base(p):
        return os.path.join(WORK, f"{name}.p{p}")

    def argv(p):
        return [os.path.join(REPO, "chip_smoke.py"), "--process-worker",
                base(p) + ".json", *(["--hold"] if p in hold else []), "--",
                *args]
    return bench_torch.start_processes(n, argv, base, env_of)


def read_text(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def multi_run(n: int, flags, ref, reads, name: str, want, kernels,
              env_of, to_file: bool) -> dict:
    """One multi-process CLI run of n processes: every process rc 0 with
    ``faults`` 0 and each of ``kernels`` launched; the merged PAF (process
    0's stdout, process 1..'s empty; or with ``to_file`` the -o file, its
    part files concatenating to it and every progress file complete) must
    equal ``want`` line for line.  The pair's wall, each process's
    map-stage reads/s, map and merge seconds, launches and peak memory."""
    out = os.path.join(WORK, f"{name}.paf")
    args = flags + [ref, reads] + (["-o", out] if to_file else [])
    t0 = time.perf_counter()
    procs = start_processes(n, args, name, env_of)
    bench_torch.stop_processes(procs, 900)
    wall = time.perf_counter() - t0
    rows = []
    for proc, base in procs:
        check(proc.returncode == 0, f"{name}: {base} rc {proc.returncode}: "
              f"{read_text(base + '.err')[-3000:]}")
        row = json.loads(read_text(base + ".json"))
        check(row["mapper"]["faults"] == 0,
              f"{name}: {row['mapper']['faults']} batches raised in {base}")
        for k in kernels:
            check(row["launches"][k] >= 1,
                  f"{name}: kernel {k} never launched in {base}")
        rows.append({
            "pid": row["pid"], "reads": row["throughput"]["reads"],
            "map_s": row["stages_s"]["map"],
            "merge_s": row["stages_s"]["merge"],
            # A resumed process may find its slice done: no reads, 0 s.
            "reads_per_s_map": (row["throughput"]["reads"]
                                / row["stages_s"]["map"]
                                if row["throughput"]["reads"] else None),
            "stages_s": row["stages_s"], "launches": row["launches"],
            "launches_by_device": row["launches_by_device"],
            "peak_bytes": row["peak_bytes"], "mapper": row["mapper"]})
    if to_file:
        merged = read_text(out)
        check("".join(read_text(f"{out}.part{p}") for p in range(n))
              == merged, f"{name}: the part files do not make the merge")
        for p in range(n):
            prog = json.loads(read_text(f"{out}.progress.p{p}"))
            check(prog["completed_reads"] == prog["total_reads"],
                  f"{name}: progress of process {p} incomplete: {prog}")
    else:
        merged = read_text(procs[0][1] + ".out")
        for _, base in procs[1:]:
            check(read_text(base + ".out") == "",
                  f"{name}: {base} wrote to stdout")
    check(merged.splitlines() == want,
          f"{name}: the merged PAF differs from the one-process run's")
    return {"processes": n, "flags": flags, "to_file": to_file,
            "env": env_of(0), "wall_s": wall, "byte_identical": True,
            "procs": rows}


def summed_launches(runs) -> dict:
    """Launches by kernel over every process of every run."""
    total: dict = {}
    for run in runs:
        for row in run["procs"]:
            for k, v in row["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def phase_processes(ref, reads, cli: dict) -> dict:
    """Two CLI processes on cuda:0 (phase 2p) under the multi-process
    variables, on phase 2's inputs: score-only to stdout (process 0 prints
    phase 2's PAF, process 1 nothing), then -c -o (the merged file is phase
    2c's -c PAF); K1, K2 and K3, then K1, K4 and K5 launched in each
    process.  ``cli`` as for ``phase_split``."""
    torch.cuda.empty_cache()
    runs = {}
    for key, flags, _cfg, kernels in SCORE_AND_C:
        want, cli_row = cli[key]
        row = multi_run(2, flags, ref, reads, f"procs_{key}", want, kernels,
                        lambda p: {"CUDA_VISIBLE_DEVICES": "0"},
                        to_file=key == "c")
        row.update(one_process_wall_s=cli_row["wall_s"],
                   one_process_reads_per_s_map=cli_row["reads_per_s_map"],
                   one_process_peak_bytes=cli_row["peak_bytes"])
        runs[key] = row
    return {"phase": "2p", "devices": ["cuda:0", "cuda:0"], "runs": runs,
            "launches": summed_launches(runs.values())}


def kill_drill(n: int, ref, recs) -> dict:
    """n processes, one a card, -o, on the reads of phase 2's most common
    length bucket; process 1 held after its first checkpointed batch
    (which must leave it mid-slice), then SIGKILLed: process 0 must exit
    non-zero within 30 s naming ``process 1`` and ``--resume``; then every
    process rerun with --resume must merge the one-process PAF of the same
    reads.  One bucket, batches of 32 and one batch in flight
    (BIOINFO1_INFLIGHT_BYTES=1): a process checkpoints its first batch
    when its second flushes, long before its slice ends."""
    from bioinfo1_tpu_torch.pipeline.mapper import _bucket_cap
    caps = [_bucket_cap(len(s)) for _, s in recs]
    cap = max(set(caps), key=caps.count)
    recs = [r for r, c in zip(recs, caps) if c == cap]
    reads = os.path.join(WORK, "reads_kill.fq")
    with open(reads, "w") as fh:
        for name, s in recs:
            fh.write(f"@{name}\n{s}\n+\n{'5' * len(s)}\n")
    flags = ["--batch-size", "32"]
    _, want = run_cli(ref, reads, recs, flags + ["--devices", "1"],
                      "kill_one.paf", ())
    out = os.path.join(WORK, "kill.paf")
    for p in range(n):
        for path in (f"{out}.part{p}", f"{out}.progress.p{p}"):
            if os.path.exists(path):
                os.remove(path)

    def one_card(p):
        return {"CUDA_VISIBLE_DEVICES": str(p),
                "BIOINFO1_INFLIGHT_BYTES": "1"}

    procs = start_processes(n, flags + [ref, reads, "-o", out], "kill",
                            one_card, hold={1})
    victim = procs[1][0]
    prog = f"{out}.progress.p1"
    try:
        deadline = time.time() + 600
        done = None
        while done is None and time.time() < deadline \
                and victim.poll() is None:
            try:
                done = json.loads(read_text(prog))
            except (OSError, ValueError):
                time.sleep(0.05)
        check(victim.poll() is None and done is not None,
              f"kill drill: process 1 ended or never checkpointed "
              f"({victim.poll()}): {read_text(procs[1][1] + '.err')[-2000:]}")
        check(0 < done["completed_reads"] < done["total_reads"],
              f"kill drill: process 1 was not held mid-slice ({done})")
        victim.send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        procs[0][0].wait(timeout=120)
        detect_s = time.perf_counter() - t_kill
    finally:
        bench_torch.stop_processes(procs, 120)
    err0 = read_text(procs[0][1] + ".err")
    rc0 = procs[0][0].returncode
    check(rc0 != 0 and detect_s < 30, f"kill drill: process 0 rc {rc0} "
          f"after {detect_s:.1f} s")
    check("process 1" in err0 and "--resume" in err0,
          f"kill drill: process 0 said {err0[-2000:]!r}")
    resumed = multi_run(n, flags + ["--resume"], ref, reads, "kill", want,
                        (), one_card, to_file=True)
    return {"reads": len(recs), "bucket": cap, "victim_progress": done,
            "process0_rc": rc0,
            "detect_s": detect_s,
            "process0_message": [line for line in err0.splitlines()
                                 if "--resume" in line],
            "other_rcs": [proc.returncode for proc, _ in procs[2:]],
            "resumed": resumed}


def phase_process_trial() -> dict:
    """Several processes over every visible card (phase 2q), on phase 2's
    inputs; every PAF must equal the one-card one-process run of the same
    flags (in-process, --devices 1, score-only and -c), no batch may
    raise.  (a) one process a card (CUDA_VISIBLE_DEVICES=p), score-only to
    stdout and -c -o; (b) with four cards or more, two processes of two
    cards each with --devices 0, under BIOINFO1_INDEX_SHARD=0 and then =1
    (score-only; each process must launch on both its cards); (c) the kill
    drill (``kill_drill``)."""
    n = torch.cuda.device_count()
    check(n >= 2, f"--process-trial needs >= 2 cards ({n})")
    ref, paths, recs, _genome, _short = write_inputs()
    reads = paths[N_READS]
    res = {"phase": "2q", "cards": n, "one": {}, "per_card": {}, "pairs": {}}
    want = {}
    for key, flags, _cfg, kernels in SCORE_AND_C:
        row, want[key] = run_cli(ref, reads, recs, flags + ["--devices", "1"],
                                 f"trial_one_{key}.paf", kernels)
        res["one"][key] = row
    torch.cuda.empty_cache()
    for key, flags, _cfg, kernels in SCORE_AND_C:
        row = multi_run(n, flags, ref, reads, f"per_card_{key}", want[key],
                        kernels, lambda p: {"CUDA_VISIBLE_DEVICES": str(p)},
                        to_file=key == "c")
        res["per_card"][key] = row
    if n >= 4:
        for shard in ("0", "1"):
            row = multi_run(
                2, ["--devices", "0"], ref, reads, f"pair_shard{shard}",
                want["score"], SCORE_AND_C[0][3],
                lambda p, s=shard: {"CUDA_VISIBLE_DEVICES":
                                    f"{2 * p},{2 * p + 1}",
                                    "BIOINFO1_INDEX_SHARD": s},
                to_file=False)
            for proc in row["procs"]:
                check(set(proc["launches_by_device"]) == {"0", "1"},
                      f"pair shard={shard}: process {proc['pid']} launched "
                      f"on {proc['launches_by_device']}")
            res["pairs"][f"shard{shard}"] = row
    res["kill"] = kill_drill(n, ref, recs)
    return res


def longread_records():
    """16 ONT-profile reads of 50 kb from the bench's genome."""
    genome = bench_torch.make_data(bench_torch.FULL)[0]
    recs = sim.simulate_reads(genome, (50000,) * N_LONG_READS,
                              np.random.default_rng(bench_torch.SEED + 70))
    return genome.tobytes().decode("latin1"), recs


def phase_longread(dev) -> dict:
    """The score-only main path at 50 kb, in-process: the reads' bands (the
    certificate drives them past W_REG) go to the cluster path as planned,
    then to the scratch kernel (ops/band.band_plan patched for W > W_REG),
    then as planned again.  Same PAF all three times; the kernel counts
    are set to 0 just before the first run and read just after it."""
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    genome, recs = longread_records()
    mapper = Mapper([("bench", genome)], MapperConfig(), device=dev)
    mapper.device_index()

    def scratch_past_w_reg(planned):
        def plan(W, B, want_parents, card=None):
            if W > bd.W_REG:
                return bd.scratch_plan(W, want_parents)
            return planned(W, B, want_parents, card)
        return plan

    runs, outs, launches = [], [], None
    for name in ("cluster", "scratch", "cluster_again"):
        # Fresh band adaptation in every run, so the batches match.
        mapper._band_by_key.clear()
        mapper._budget_boost.clear()
        before = mapper.counters.as_dict()
        counters = reset_launches()
        with band_plan_as(scratch_past_w_reg if name == "scratch"
                          else lambda planned: planned):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lines = mapper.map_records(recs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = {k: getattr(w, a) for k, (w, a) in counters.items()}
        paths = dict(bd.align_scores_banded.path_launches)
        if launches is None:
            launches = got
        after = mapper.counters.as_dict()
        check(after["faults"] == 0, f"50 kb {name}: a batch raised")
        runs.append({"run": name, "wall_s": wall,
                     "reads_per_s_map": len(recs) / wall,
                     "paf_lines": len(lines), "band_path_launches": paths,
                     "bands": {f"{cap},{int(fc)}": band for (cap, fc), band
                               in mapper._band_by_key.items()},
                     "counters": {k: after[k] - before.get(k, 0)
                                  for k in after if k != "cert_hit_rate"
                                  and isinstance(after[k], (int, float))}})
        outs.append(lines)
    check(outs[0] == outs[1] == outs[2],
          "50 kb reads: the PAF differs between the cluster and the scratch "
          "path")
    check(len(outs[0]) >= 0.9 * len(recs),
          f"50 kb reads: only {len(outs[0])} of {len(recs)} mapped")
    check(launches["band_score_cluster"] >= 1,
          "the cluster path never launched on the 50 kb reads")
    check(runs[1]["band_path_launches"]["cluster"] == 0
          and runs[1]["band_path_launches"]["scratch"] >= 1,
          "the scratch run did not take the scratch kernel")
    del mapper
    torch.cuda.empty_cache()
    return {"phase": "2L", "reads": len(recs), "read_len": 50000,
            "byte_identical": True, "runs": runs, "launches": launches}


def ultralong_records(fragment: int = ULTRA_FRAGMENT):
    """8 ONT-profile reads of fragments of ``fragment`` bases (reads of
    ~100 kb by default) from the bench's genome."""
    genome = bench_torch.make_data(bench_torch.FULL)[0]
    recs = sim.simulate_reads(genome, (fragment,) * N_ULTRA_READS,
                              np.random.default_rng(bench_torch.SEED + 71))
    return genome.tobytes().decode("latin1"), recs


def cigar_spans(cigar: str) -> dict:
    """Bases of each CIGAR op (M, I, D)."""
    import re
    out = {"M": 0, "I": 0, "D": 0}
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        out[op] += int(n)
    return out


def cigar_score(cigar: str, q: str, t: str, t0: int, match: int,
                mismatch: int, gap: int) -> int:
    """The score of ``cigar`` (the reference's convention: I consumes the
    target, D the query) over query ``q`` and target ``t`` from ``t0``,
    with the '-' rule (a gap over a '-' byte is free)."""
    import re
    i, j, score = 0, t0, 0
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        for _ in range(int(n)):
            if op == "M":
                score += match if q[i] == t[j] else mismatch
                i, j = i + 1, j + 1
            elif op == "I":
                score += 0 if t[j] == "-" else gap
                j += 1
            else:
                score += 0 if q[i] == "-" else gap
                i += 1
    return score


def phase_ultralong(dev) -> dict:
    """Phase 2U: the score-only main path on reads of 100 kb, in-process.
    A fresh pass realigns them at W = 65,536 and the adapted pass runs the
    fused step at the band they proved: both past W_CLUSTER, so on strips
    as planned (launched in each pass), then again with the scratch kernel
    past W_CLUSTER (scratch_past_cluster), then with K2's "epochs" path
    there (epochs_past_cluster); each run's path alone takes the wide
    bands, the PAFs of a pass must be byte-identical, no batch may raise.  Then -c on 2 of the reads (K4 on
    strips, B = 1 a chunk): every CIGAR spans its PAF line's extents and
    scores, on the host, what the score-only run gave the read."""
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    genome, recs = ultralong_records()
    mapper = Mapper([("bench", genome)], MapperConfig(), device=dev)
    mapper.device_index()
    runs, pafs, launches = [], {}, None
    for name, make in (("strip", lambda planned: planned),
                       ("scratch", scratch_past_cluster),
                       ("epochs", epochs_past_cluster)):
        mapper._band_by_key.clear()
        mapper._budget_boost.clear()
        for pass_ in ("fresh", "adapted"):
            before = mapper.counters.as_dict()
            counters = reset_launches()
            with band_plan_as(make):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lines = mapper.map_records(recs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            got = {k: getattr(w, a) for k, (w, a) in counters.items()}
            paths = dict(bd.align_scores_banded.path_launches)
            if launches is None:
                launches = got
            after = mapper.counters.as_dict()
            check(after["faults"] == 0, f"100 kb {name} {pass_}: a batch "
                                        "raised")
            runs.append({"run": name, "pass": pass_, "wall_s": wall,
                         "reads_per_s_map": len(recs) / wall,
                         "paf_lines": len(lines),
                         "band_path_launches": paths,
                         "bands": {f"{cap},{int(fc)}": band for (cap, fc),
                                   band in mapper._band_by_key.items()},
                         "counters": {k: after[k] - before.get(k, 0)
                                      for k in after
                                      if k != "cert_hit_rate" and
                                      isinstance(after[k], (int, float))}})
            pafs[name, pass_] = lines
            others = {"strip", "scratch", "epochs"} - {name}
            check(paths[name] >= 1 and not any(paths[x] for x in others),
                  f"100 kb {name} {pass_}: the {name} path did not take "
                  f"the wide bands alone ({paths})")
    for pass_ in ("fresh", "adapted"):
        for other in ("scratch", "epochs"):
            check(pafs["strip", pass_] == pafs[other, pass_],
                  f"100 kb reads, {pass_} pass: the PAF differs between "
                  f"the strip path and the {other} path")
    check(len(pafs["strip", "fresh"]) >= 0.9 * len(recs),
          f"100 kb reads: only {len(pafs['strip', 'fresh'])} of "
          f"{len(recs)} mapped")
    res = {"phase": "2U", "reads": len(recs),
           "read_lens": [len(r) for _, r in recs],
           "byte_identical": True, "runs": runs, "launches": launches,
           "cigar": ultralong_cigar(mapper, recs[:N_ULTRA_CIGAR_READS]),
           "bucket_top": bucket_top_faults(mapper)}
    del mapper
    torch.cuda.empty_cache()
    res["golden"] = golden_ultra(dev)
    return res


def golden_ultra(dev) -> dict:
    """Reads past 131 kb (GOLDEN_ULTRA: a ~150 kb read in the 196,608
    length bucket, base match budget 73,728, and a ~250 kb read in the
    262,144 bucket, 98,304), each run mapped alone in-process, score-only,
    a fresh and an adapted pass, as planned (strips) and with K2's
    "epochs" path forced past W_CLUSTER (epochs_past_cluster): no batch may
    raise, K1's wide path and the route's path must launch in each pass
    and the other not, and each pass's PAF must have the run's pinned
    sha256 (a CLI's on the CPU: the JAX package's, or the port's plain
    version of every kernel where the JAX CLI does not finish).
    ``launches`` are the first run's fresh pass's (strips)."""
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    from bioinfo1_tpu_torch.utils import golden
    pin = golden.load(GOLDEN_ULTRA)
    genome, recs = golden.records(pin["recipe"])
    mapper = Mapper([(pin["recipe"]["ref_name"], genome)], MapperConfig(),
                    device=dev)
    mapper.device_index()
    runs, launches = [], None
    for run, route in itertools.product(pin["runs"], ("strip", "epochs")):
        reads = golden.run_records(recs, run)
        mapper._band_by_key.clear()
        mapper._budget_boost.clear()
        for pass_ in ("fresh", "adapted"):
            name = f"{run['name']} {route} {pass_}"
            before = mapper.counters.as_dict()
            counters = reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with band_plan_as(epochs_past_cluster if route == "epochs"
                              else lambda planned: planned):
                lines = mapper.map_records(reads)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: getattr(w, a) for k, (w, a) in counters.items()}
            launches = launches or got
            after = mapper.counters.as_dict()
            paths = dict(bd.align_scores_banded.path_launches)
            sha = golden.sha256("".join(line + "\n" for line in lines))
            runs.append({
                "run": run["name"], "route": route, "pass": pass_,
                "read_lens": [len(s) for _, s in reads], "wall_s": wall,
                "paf_lines": len(lines), "sha256": sha,
                "band_path_launches": paths,
                "lis_chain_wide": got["lis_chain_wide"],
                "counters": {k: after[k] - before.get(k, 0)
                             for k in after if k != "cert_hit_rate"
                             and isinstance(after[k], (int, float))}})
            check(runs[-1]["counters"]["faults"] == 0,
                  f"{name}: a batch raised")
            other = "epochs" if route == "strip" else "strip"
            check(got["lis_chain_wide"] >= 1 and paths[route] >= 1
                  and paths[other] == 0,
                  f"{name}: K1's wide path or the {route} path never "
                  f"launched, or the {other} path did "
                  f"({got['lis_chain_wide']}, {paths})")
            check(sha == run["sha256"] and len(lines) == len(reads),
                  f"{name}: {len(lines)} PAF lines, sha256 {sha}, not the "
                  f"pinned {run['sha256']}")
    del mapper
    torch.cuda.empty_cache()
    return {"runs": runs, "launches": launches}


def phase_c12(dev) -> dict:
    """Phase 2W: match budgets past 2,097,152 on the main path (ROADMAP
    C12, closed).  (a) GOLDEN_4MB's read of 4,200,000 bases alone,
    in-process, score-only, a fresh and an adapted pass: its fused call
    asks K1 for 2,359,296 matches a row; K1's wide path must launch and
    each pass give C12_OUTCOME and the pinned sha256 (the port's CLI on
    the CPU).  (b) the first golden recipe's reads (GOLDEN) with every
    match budget forced to FORCED_BUDGET (MapperConfig.
    initial_match_budget): every K1 call on the wide path (its narrow
    paths never launch), faults 0, the PAF the default run's pinned
    sha256."""
    from bioinfo1_tpu_torch.ops import chain as ch
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    from bioinfo1_tpu_torch.utils import golden

    def one_pass(mapper, recs, sha, what):
        before = mapper.counters.as_dict()
        reset_launches()
        err = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            lines = mapper.map_records(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = mapper.counters.as_dict()
        res = {"pass": what, "reads": [len(s) for _, s in recs],
               "faults": after["faults"] - before["faults"],
               "paf_lines": len(lines),
               "sha256": golden.sha256("".join(x + "\n" for x in lines)),
               "k1_path_launches": dict(ch.lis_chain.path_launches),
               "budget_retries": after["budget_retries"]
               - before["budget_retries"],
               "errors": sorted(set(err.getvalue().splitlines()))[:4],
               "wall_s": wall}
        check(res["sha256"] == sha, f"{what}: sha256 {res['sha256']}, not "
                                    f"the pinned {sha}")
        check(res["faults"] == 0, f"{what}: a batch raised")
        check(res["k1_path_launches"]["wide"] >= 1,
              f"{what}: K1's wide path never launched")
        return res

    runs = []
    pin = golden.load(GOLDEN_4MB)
    genome, recs = golden.records(pin["recipe"])
    reads = golden.run_records(recs, pin["runs"][0])
    mapper = Mapper([(pin["recipe"]["ref_name"], genome)], MapperConfig(),
                    device=dev)
    mapper.device_index()
    for pass_ in ("fresh", "adapted"):
        runs.append(one_pass(mapper, reads, pin["runs"][0]["sha256"],
                             f"4.2 Mb read, {pass_}"))
        got = {k: runs[-1][k] for k in C12_OUTCOME}
        check(got == C12_OUTCOME, f"ROADMAP C12: the 4.2 Mb read gave "
                                  f"{got}, not {C12_OUTCOME}")
    del mapper, genome, recs, reads
    torch.cuda.empty_cache()
    pin = golden.load(GOLDEN)
    genome, recs = golden.records(pin["recipe"])
    (sha,) = [r["sha256"] for r in pin["runs"] if r["flags"] == ["-a",
                                                                 "global"]]
    mapper = Mapper([(pin["recipe"]["ref_name"], genome)],
                    MapperConfig(initial_match_budget=FORCED_BUDGET),
                    device=dev)
    runs.append(one_pass(mapper, recs, sha,
                         f"golden reads at budget {FORCED_BUDGET}"))
    narrow = {k: v for k, v in runs[-1]["k1_path_launches"].items()
              if k != "wide"}
    check(not any(narrow.values()), f"golden reads at budget "
                                    f"{FORCED_BUDGET}: K1's narrow paths "
                                    f"launched ({narrow})")
    del mapper
    torch.cuda.empty_cache()
    return {"phase": "2W", "runs": runs}


def cli_outcome(root: str, ref: str, reads: str, timeout: int) -> dict:
    """The CLI of the tree at ``root`` on one reference and reads file,
    with --profile and fresh bands: its rc, PAF lines and their sha256,
    the mapper's faults, its first ERROR lines and its wall."""
    from bioinfo1_tpu_torch.utils import golden
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bioinfo1_tpu_torch.cli", "--profile", ref,
         reads], cwd=root, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, BIOINFO1_BAND_CACHE="0"))
    return {"root": root, "rc": proc.returncode,
            "paf_lines": len(proc.stdout.splitlines()),
            "sha256": golden.sha256(proc.stdout),
            "faults": (parse_profile(proc.stderr)["mapper"]["faults"]
                       if proc.returncode == 0 else None),
            "errors": sorted({x for x in proc.stderr.splitlines()
                              if x.startswith("ERROR")})[:4],
            "wall_s": time.perf_counter() - t0}


def megabase_records():
    """(genome, [record]): the bench's genome and GOLDEN_MB's read, one
    ONT-profile read of a fragment of MB_FRAGMENT bases."""
    genome = bench_torch.make_data(bench_torch.FULL)[0]
    recs = sim.simulate_reads(
        genome, (MB_FRAGMENT,),
        np.random.default_rng(bench_torch.SEED + MB_SEED_OFFSET))
    return genome.tobytes().decode("latin1"), recs


def megabase_rows(dev, call, scoring) -> list:
    """K2 on the megabase read's realign pair (``call``: the arrays, band,
    dash_free and mode that Mapper._banded_pass took): at the card's
    w_strip (540,672 lanes on an H100 SXM) on the strip path as planned
    and on the "epochs" path, held equal, timed in turns; at the realign's
    own W_MB on the "epochs" path alone, timed, held to the realign pass's
    outputs.  Never on the scratch kernel."""
    from bioinfo1_tpu_torch.ops import band as bd
    qa, qla, ta, tla, W, dash_free, mode, res = call
    q, ql, t, tl = (torch.from_numpy(x).to(dev) for x in (qa, qla, ta, tla))
    card = bd.strip_card(dev)
    rows = []

    def run(W):
        return bd.align_scores_banded(q, ql, t, tl, *scoring, band=W,
                                      mode=mode, dash_free=dash_free)

    def epochs(W):
        with band_plan_as(epochs_past_cluster):
            return run(W)
    Ws = card.w_strip
    check(bd.band_plan(Ws, 1, False, card).path == "strip",
          f"W={Ws}: not the strip path")
    want, got = run(Ws), epochs(Ws)
    err = max_abs_err(got, want)
    check(err == 0, f"megabase pair at W={Ws}: the epochs path differs "
                    f"from the strips (max abs err {err})")
    del want, got
    times = paired_ms({"epochs": lambda: epochs(Ws),
                       "strip": lambda: run(Ws)})
    rows.append(with_bound({
        "call": f"band epochs vs strips megabase realign pair W={Ws} B=1 "
                f"n={q.shape[1]} mode={mode} dash_free={dash_free}",
        "ms": min(times["epochs"]), "plain_ms": None, "max_abs_err": err,
        "against": "strip path", "paired_ms": times,
        "strip_ms": min(times["strip"]),
        **dataclasses.asdict(bd.epoch_plan(Ws)),
        **band_work(q, ql, t, tl, Ws, False)}, "band_score_epochs"))
    torch.cuda.empty_cache()
    plan = bd.band_plan(W, 1, False, card)
    check(W == W_MB and plan.path == "epochs",
          f"the megabase realign call: W={W} on the {plan.path} path")
    got = run(W)
    want = [torch.from_numpy(np.asarray(x, np.int32)).to(dev)
            for x in (res.score, res.goal_i, res.goal_j)]
    err = max(max_abs_err(a, b) for a, b in zip(
        (got.score, got.goal_i, got.goal_j), want))
    check(err == 0, "the megabase realign pair: K2 differs from the "
                    "realign pass's own call")
    rows.append(with_bound({
        "call": f"band epochs megabase realign pair W={W} B=1 "
                f"n={q.shape[1]} mode={mode} dash_free={dash_free}",
        "ms": cuda_ms(lambda: run(W), 1), "plain_ms": None,
        "max_abs_err": err, "against": "the realign pass's call",
        **dataclasses.asdict(plan), **band_work(q, ql, t, tl, W, False)},
        "band_score_epochs"))
    del q, ql, t, tl, got
    torch.cuda.empty_cache()
    return rows


def phase_megabase(dev, rows: dict) -> dict:
    """Phase 2E: the default route on a megabase read.  GOLDEN_MB's read
    (~1.2 Mb) alone, in-process, score-only, a fresh and an adapted pass:
    faults 0, one PAF line at the pinned sha256, K2's "epochs" path
    launched and the scratch kernel never; the fresh pass's realign call
    must be at W_MB.  Its captured realign pair gives the kernel table's
    megabase rows (megabase_rows), appended to ``rows``."""
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    from bioinfo1_tpu_torch.utils import golden
    with open(GOLDEN_MB) as fh:
        pin = json.load(fh)
    genome, recs = megabase_records()
    check(len(recs[0][1]) == pin["read_len"],
          f"the megabase read has {len(recs[0][1])} bases, not "
          f"{pin['read_len']}")
    cfg = MapperConfig()
    mapper = Mapper([("bench", genome)], cfg, device=dev)
    mapper.device_index()
    calls, real = [], mapper._banded_pass

    def capture(qa, ql, ta, tl, W, dash_free, want_parents, strict):
        res = real(qa, ql, ta, tl, W, dash_free, want_parents, strict)
        calls.append((qa.copy(), ql.copy(), ta.copy(), tl.copy(), W,
                      dash_free, mapper._mode, res))
        return res
    mapper._banded_pass = capture
    runs, launches = [], None
    for pass_ in ("fresh", "adapted"):
        before = mapper.counters.as_dict()
        counters = reset_launches()
        n_calls = len(calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = mapper.map_records(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: getattr(w, a) for k, (w, a) in counters.items()}
        launches = launches or got
        paths = dict(bd.align_scores_banded.path_launches)
        after = mapper.counters.as_dict()
        sha = golden.sha256("".join(x + "\n" for x in lines))
        runs.append({"pass": pass_, "read_len": len(recs[0][1]),
                     "wall_s": wall, "paf_lines": len(lines), "sha256": sha,
                     "band_path_launches": paths,
                     "realign_W": [c[4] for c in calls[n_calls:]],
                     "bands": {f"{cap},{int(fc)}": band for (cap, fc), band
                               in mapper._band_by_key.items()},
                     "counters": {k: after[k] - before.get(k, 0)
                                  for k in after if k != "cert_hit_rate"
                                  and isinstance(after[k], (int, float))}})
        name = f"megabase read, {pass_}"
        check(runs[-1]["counters"]["faults"] == 0, f"{name}: a batch raised")
        check(len(lines) == 1 and sha == pin["sha256"],
              f"{name}: {len(lines)} PAF lines, sha256 {sha}, not the "
              f"pinned {pin['sha256']}")
        check(paths["epochs"] >= 1 and paths["scratch"] == 0,
              f"{name}: the epochs path did not launch, or the scratch "
              f"kernel did ({paths})")
    realign = [c for c in calls if c[4] == W_MB]
    check(runs[0]["realign_W"] == [W_MB] and realign,
          f"the fresh pass realigned at {runs[0]['realign_W']}, not "
          f"[{W_MB}]")
    mapper._banded_pass = real
    del mapper
    torch.cuda.empty_cache()
    mb_rows = megabase_rows(dev, realign[0],
                            (cfg.match, cfg.mismatch, cfg.gap))
    rows["band_score_epochs"] += mb_rows
    return {"phase": "2E", "runs": runs, "launches": launches,
            "pinned_by": pin["pinned_by"], "rows": mb_rows}


def phase_megabase_trial(dev, parent: str = None) -> dict:
    """Phase 1m (--megabase-trial [--parent DIR]): GOLDEN_MB's read through
    this tree's CLI on the card (K2's "epochs" path) and, with ``parent``,
    through the CLI of the tree there (before the "epochs" path: the
    scratch kernel past the card's w_strip): rc, PAF lines, sha256, the
    mapper's faults and the wall of each.  The pin of GOLDEN_MB comes from
    such a run."""
    genome, recs = megabase_records()
    os.makedirs(WORK, exist_ok=True)
    ref = os.path.join(WORK, "megabase_ref.fa")
    reads = os.path.join(WORK, "megabase_reads.fq")
    with open(ref, "w") as fh:
        fh.write(">bench\n")
        for i in range(0, len(genome), 80):
            fh.write(genome[i:i + 80] + "\n")
    with open(reads, "w") as fh:
        for name, seq in recs:
            fh.write(f"@{name}\n{seq}\n+\n{'5' * len(seq)}\n")
    res = {"phase": "1m", "read_len": len(recs[0][1]), "cli": {}}
    for name, root in (("this", REPO), ("parent", parent)):
        if root is not None:
            res["cli"][name] = cli_outcome(root, ref, reads, 3300)
            emit({"phase": "1m", "cli": {name: res["cli"][name]}})
    got = res["cli"]["this"]
    check(got["rc"] == 0 and got["faults"] == 0 and got["paf_lines"] == 1,
          f"this tree's CLI on the megabase read: {got}")
    return res


def phase_epoch_trial(dev) -> dict:
    """Phase 1e (--epoch-trial; the library built with
    BIOINFO1_BAND_EPOCH_TRIAL, which adds the halo of 32 lanes): K2's
    "epochs" path at W = W_MB on one ~1.2 Mb read (a fragment of 1,196,000-
    1,200,000 bases, ONT profile, against a region 3,000 bases longer), in
    strips of each of STRIP_WIDTHS with halos of 32 and 64 lanes, every
    output held to the first, each timed twice; and the launches alone,
    the same call on an empty read (every CTA leaves at once).  The trial
    behind ops/band.EPOCH_WIDTH and EPOCH_HALO."""
    from bioinfo1_tpu_torch.ops import band as bd
    rng = np.random.default_rng(bench_torch.SEED + 73)
    n, m = 1_200_000, 1_203_000
    ln = int(rng.integers(1_196_000, 1_200_001))
    tgt = sim.random_genome(ln + 3000, rng)
    qry = sim.mutate_read(tgt[:ln], rng)[:n]
    qa = np.zeros((1, n), np.uint8)
    ta = np.zeros((1, m), np.uint8)
    qa[0, :len(qry)], ta[0, :len(tgt)] = qry, tgt
    q, t = (torch.from_numpy(x).to(dev) for x in (qa, ta))
    ql, tl = (torch.tensor([v], dtype=torch.int32, device=dev)
              for v in (len(qry), len(tgt)))
    empty = torch.zeros(1, dtype=torch.int32, device=dev)
    sc = (1, -1, -1)
    res = {"phase": "1e", "W": W_MB, "n": len(qry), "m": len(tgt),
           "rows": []}
    want = None
    for halo in (64, 32):
        for S in bd.STRIP_WIDTHS:
            with band_plan_as(epochs_at(S, halo)):
                def run(a=ql, b=tl):
                    return bd.align_scores_banded(q, a, t, b, *sc, band=W_MB,
                                                  mode=0, dash_free=True)
                got = run()
                if want is None:
                    want = got
                check(max_abs_err(got, want) == 0,
                      f"epochs at S={S}, H={halo} differ")
                row = {"width": S, "halo": halo,
                       "ms": [cuda_ms(run, 1) for _ in range(2)],
                       "empty_ms": cuda_ms(lambda: run(empty, empty), 1),
                       "launches": -(-bd.band_shapes(n, m, W_MB)[3]
                                     // (2 * halo))}
            res["rows"].append(row)
            emit({"phase": "1e", "row": row})
    res["score"] = int(want.score[0])
    return res


# csrc/lis_chain.cu's line that starts each chunk's q_lo scan at the wide
# path's search (--wide-trial times the prologue without it).
SCAN_START = "start = hit ? lo + __ffs(hit) - 1 : hi;"


def phase_wide_trial(dev, parent: str = None) -> dict:
    """Phase 1x (--wide-trial [--parent DIR]): K1's wide path past
    2,097,152 matches.  The colinear row of WIDE_COLINEAR_N split into
    prologue, DP and chase (chain_profile_split) by this tree's K1 and by a
    copy of it whose q_lo scans start at chunk 0 (SCAN_START removed);
    GOLDEN_4MB's read through this tree's CLI on the card and, with
    ``parent``, through the CLI of the tree there (the outcome before a
    change: PAF lines, sha256, the mapper's faults, its errors); and with
    ``parent`` K1 of both trees in one process, alternating, on the kernel
    table's shape, the 50 kb reads' rows, the ~150 kb read's rows and the
    colinear row of 70,000 (the older library built by its own
    kernels/build.py, called through its own signature)."""
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import chain as ch
    from bioinfo1_tpu_torch.utils import golden
    res = {"phase": "1x"}
    src = open(os.path.join(build.CSRC, "lis_chain.cu")).read()
    check(SCAN_START in src, "csrc/lis_chain.cu has no SCAN_START line")
    from0 = os.path.join(WORK, "lis_chain_from0.cu")
    with open(from0, "w") as fh:
        fh.write(src.replace(SCAN_START, "start = 0;"))
    splits = {"k1": chain_profile_split(),
              "from0": chain_profile_split(from0, "from0")}
    N = WIDE_COLINEAR_N
    up = torch.arange(1, N + 1, dtype=torch.int32, device=dev)[None]
    cnt = torch.full((1,), N, dtype=torch.int32, device=dev)
    want = ch.lis_chain(up, up, cnt)
    res["colinear"] = {name: [split(up, up, cnt, want) for _ in range(2)]
                       for name, split in splits.items()}
    del up, cnt, want
    pin = golden.load(GOLDEN_4MB)
    ref, reads = golden.write_inputs(pin["recipe"],
                                     os.path.join(WORK, "golden_4mb"),
                                     pin["runs"][0])
    res["read_4mb"] = {name: cli_outcome(root, ref, reads, 900)
                       for name, root in (("this", REPO), ("parent", parent))
                       if root is not None}
    got = res["read_4mb"]["this"]
    check(got["rc"] == 0 and got["faults"] == 0
          and got["sha256"] == pin["runs"][0]["sha256"],
          f"this tree's CLI on the 4.2 Mb read: {got}")
    if parent is not None:
        res["paired"] = paired_chain(dev, parent)
    return res


def paired_chain(dev, parent: str) -> dict:
    """K1 of the tree at ``parent`` and of this one on the same inputs in
    one process: each output equal to this tree's wrapper's, then six
    rounds of each, the order alternating; ms of each round."""
    import ctypes
    import importlib.util
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import chain as ch
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "bioinfo1_tpu_torch", "kernels",
                                     "build.py"))
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    old.ensure_built()
    fns = {}
    for name, mod in (("parent", old), ("this", build)):
        fn = ctypes.CDLL(mod.LIB_PATH).bioinfo1_lis_chain
        fn.argtypes = mod._SIGNATURES["bioinfo1_lis_chain"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    rng = np.random.default_rng(1)
    shapes = {"R=512 N=1536": chain_inputs(rng, *CHAIN_SHAPES[0], dev),
              "50kb": chain_rows_50k(dev)[0],
              "150kb": chain_rows_ultra(dev, 0)[0],
              "colinear N=70000": chase_rows(WIDE_CHASE_N, dev)["chain"]}
    out = {}
    for shape, (f, r, cnt) in shapes.items():
        R, N = f.shape
        plan = ch.chain_plan(N)
        n_pad = -(-N // ch.CHAIN_C) * ch.CHAIN_C
        wide = plan.path == "wide"
        rows = [torch.empty((R, n_pad), device=dev,
                            dtype=torch.int64 if wide else torch.int32),
                torch.empty((R, n_pad), device=dev,
                            dtype=torch.int32 if wide else torch.int16),
                torch.empty((R, n_pad // ch.CHAIN_C), device=dev,
                            dtype=torch.int32)]
        ends = torch.empty((5, R), dtype=torch.int32, device=dev)
        want = ch.lis_chain(f, r, cnt)
        runs = {}
        for name, fn in fns.items():
            # The older entry point has no q_lo row (11 arguments).
            scratch = [x.data_ptr() for x in rows][:len(fn.argtypes) - 9]
            args = [f.data_ptr(), r.data_ptr(), cnt.data_ptr(), R, N,
                    *scratch, ends.data_ptr(),
                    ch.CHAIN_PATHS.index(plan.path), plan.threads, None]

            def run(fn=fn, args=args, name=name):
                check(fn(*args) == 0, f"{name} K1 failed")
            run()
            torch.cuda.synchronize()
            check(max_abs_err(ch.ChainResult(*ends.unbind(0)), want) == 0,
                  f"{name} K1 differs on {shape}")
            runs[name] = run
        reps = 5 if N > 65535 else 20
        times = {name: [] for name in runs}
        for k in range(6):
            for name in (("parent", "this") if k % 2 == 0
                         else ("this", "parent")):
                times[name].append(cuda_ms(runs[name], reps))
        out[shape] = {"path": plan.path,
                      **{name: {"median_ms": statistics.median(v),
                                "ms": v} for name, v in times.items()}}
    return out


def bucket_top_faults(mapper) -> dict:
    """ROADMAP C11: two reads of fragments of 100,000 bases that land in
    the 98,304 length bucket (98.1-98.2 kb), mapped as planned: the faults
    (none, now that K1 runs the doubled budget of 73,728 matches on its
    wide path), the PAF lines and their sha256, the wall.  The outcome
    must stay the documented one (C11_OUTCOME)."""
    from bioinfo1_tpu_torch.pipeline import mapper as mp
    from bioinfo1_tpu_torch.utils import golden
    _, recs = ultralong_records(ULTRA_LEN)
    floor = mapper.cfg.k + mapper.cfg.w - 1
    top = [r for r in recs if mp._bucket_cap(len(r[1]), floor) == 98304][:2]
    mapper._band_by_key.clear()
    mapper._budget_boost.clear()
    before = mapper.counters.faults
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        lines = mapper.map_records(top)
    torch.cuda.synchronize()
    res = {"reads": [len(r) for _, r in top], "paf_lines": len(lines),
           "faults": mapper.counters.faults - before,
           "sha256": golden.sha256("".join(line + "\n" for line in lines)),
           "errors": sorted(set(err.getvalue().splitlines()))[:4],
           "wall_s": time.perf_counter() - t0}
    got = {k: res[k] for k in C11_OUTCOME}
    check(got == C11_OUTCOME, f"ROADMAP C11: the 98,304 bucket's reads gave "
                              f"{got}, not {C11_OUTCOME}")
    return res


def ultralong_cigar(mapper, recs) -> dict:
    """-c on ``recs`` through the strip path: the PAF lines, every CIGAR
    against its line's extents, its score on the host against the
    score-only mapper's score of the read (map_batch on the same reads,
    before the mapper turns to -c)."""
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.pipeline.mapper import MapperConfig
    cfg = mapper.cfg
    seqs = [s for _, s in recs]
    mapper._band_by_key.clear()
    score_only = mapper.map_batch(seqs)
    mapper.cfg = MapperConfig(output_cigar=True)
    mapper._band_by_key.clear()
    mapper._budget_boost.clear()
    try:
        counters = reset_launches()
        t0 = time.perf_counter()
        lines = mapper.map_records(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(w, a) for k, (w, a) in counters.items()}
        paths = dict(bd.align_scores_banded.path_launches)
        mapper._band_by_key.clear()
        mapped = mapper.map_batch(seqs)
    finally:
        mapper.cfg = cfg
    check(mapper.counters.faults == 0, "100 kb -c: a batch raised")
    check(launches["band_score"] == 0 and paths["strip"] >= 1
          and launches["walk_parents"] >= 1,
          f"100 kb -c: K4 did not run on strips ({paths}, {launches})")
    check(len(lines) == len(recs), f"100 kb -c: {len(lines)} PAF lines")
    reads = []
    for line, m, s, seq in zip(lines, mapped, score_only, seqs):
        f = line.split("\t")
        cig = next(x[5:] for x in f if x.startswith("cg:Z:"))
        span = cigar_spans(cig)
        q, t = mapper._region_strings(seq, m.q_begin, m.q_end, m.t_begin,
                                      m.t_end, m.is_fwd)
        host = cigar_score(cig, q, t, m.target_begin or 0, mapper.cfg.match,
                           mapper.cfg.mismatch, mapper.cfg.gap)
        ok = (m.mapped and s.mapped and m.cigar == cig
              and span["M"] + span["D"] == int(f[3]) - int(f[2])
              and span["M"] + span["I"] == int(f[8]) - int(f[7])
              and host == m.score == s.score)
        check(ok, f"100 kb -c: read {f[0]}'s CIGAR does not span its PAF "
                  f"extents or score its score-only score ({span}, "
                  f"{f[2:4]}, {f[7:9]}, host {host}, -c {m.score}, "
                  f"score-only {s.score})")
        reads.append({"read": f[0], "ops": span, "score": host})
    return {"reads": reads, "wall_s": wall,
            "reads_per_s_map": len(recs) / wall, "launches": launches,
            "band_path_launches": paths}


def pairs_100k(rng, dev, B: int = N_ULTRA_READS) -> list:
    """The shape 100 kb reads give K2 in their realign pass: B reads of
    ~96-100 kb against regions 3,000 bases longer, (B, n) = (8, 100000),
    m = 104000; W = 65,536."""
    return region_pairs(rng, dev, B, ULTRA_LEN, ULTRA_LEN + 4000,
                        (96000, 100001), 3000)


def phase_strip_trial(dev) -> dict:
    """Phase 1u (--strip-trial): K2 / K4 on strips against the scratch
    kernel (the kernel table's shape, W = 32,896, B = 32, n = 4,096, and
    the 100 kb reads' realign shape, W = 65,536, B = 8; K4 at its table
    shape and at one 100 kb read, B = 1) and against the cluster path at
    its 50 kb shape (W = 25,088, B = 11, strips forced), every strip width
    at the table's shape and at 1, 2, 4, 6, 8 and 12 reads of 100 kb (K4
    at one), the bound of each row and the integer
    instructions of the strip kernel's interior pair loop per cell; every
    pair of outputs must be equal."""
    import sass_census as sass
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import band as bd
    sc = (1, -1, -1)
    rows = []
    card = bd.strip_card(dev)

    def strip_widths(out, name, pairs, W, parents):
        """The call at every strip width whose strips of a read the card
        holds at once, each in as few launches as fit, against the planned
        width's output: ms and launches by width into ``out[name]``."""
        def run():
            return bd.align_scores_banded(*pairs, *sc, band=W, mode=0,
                                          dash_free=True,
                                          want_parents=parents)
        m_eff = bd.band_shapes(pairs[0].shape[1], pairs[2].shape[1], W)[2]
        err_fn = (parents_err(pairs[1], pairs[3], m_eff) if parents
                  else max_abs_err)
        want = run()
        res = {"planned": bd.band_plan(W, pairs[0].shape[0], parents,
                                       card).strip}
        for S in bd.STRIP_WIDTHS:
            if card.held(S) < -(-W // S):
                continue
            with band_plan_as(strip_width(S)):
                check(err_fn(run(), want) == 0, f"{name}: strips of {S} "
                                                "differ")
                plan = bd.band_plan(W, pairs[0].shape[0], parents, card)
                res[S] = {"ms": cuda_ms(run, 2), "launches": -(-pairs[0]
                          .shape[0] // plan.reads_per_launch)}
        out[name] = res
        del want
        torch.cuda.empty_cache()

    def row_of(name, pairs, W, parents, other, reps=1, extra=None):
        """The planned call against the same call under ``other`` (a
        band_plan factory), both timed; equal outputs."""
        q, ql, t, tl = pairs

        def run():
            return bd.align_scores_banded(q, ql, t, tl, *sc, band=W, mode=0,
                                          dash_free=True,
                                          want_parents=parents)
        m_eff = bd.band_shapes(q.shape[1], t.shape[1], W)[2]
        err_fn = parents_err(ql, tl, m_eff) if parents else max_abs_err
        got = run()
        with band_plan_as(other):
            err = err_fn(got, run())
            check(err == 0, f"{name}: outputs differ")
        del got
        torch.cuda.empty_cache()
        ms = cuda_ms(run, reps)
        with band_plan_as(other):
            other_ms = cuda_ms(run, 1)
        row = {"call": name, "ms": ms, "other_ms": other_ms,
               "ms_again": cuda_ms(run, reps), "max_abs_err": err,
               **band_work(q, ql, t, tl, W, parents),
               **dataclasses.asdict(bd.band_plan(W, q.shape[0], parents,
                                                 card))}
        row["bound_ms"], row["bound_by"] = bound(
            row, NEEDED_OPS["band_parents" if parents else "band_score"])
        row["time_over_bound"] = row["ms"] / row["bound_ms"]
        row.update(extra or {})
        rows.append(row)
        emit({"phase": "1u", "row": row})
        torch.cuda.empty_cache()

    rng = np.random.default_rng(1)
    q, ql, t, tl = pair_inputs(rng, 32, 4096, 6144, dev)
    table = [q, ql, t, tl]
    row_of("K2 strips vs scratch W=32896 B=32 n=4096", table, 32896, False,
           scratch_past_cluster, reps=3)
    widths = {"card": dataclasses.asdict(card)}
    strip_widths(widths, "K2 W=32896 B=32", table, 32896, False)
    row_of("K4 strips vs scratch W=32896 B=16 n=4096",
           [x[:16].contiguous() for x in table], 32896, True,
           scratch_past_cluster)
    del q, ql, t, tl, table
    torch.cuda.empty_cache()
    pairs = pairs_50k(np.random.default_rng(5), dev)
    row_of("K2 cluster (planned) vs strips W=25088 B=11 n=50000", pairs,
           25088, False, strip_always, reps=2)
    row_of("K4 cluster (planned) vs strips W=25088 B=11 n=50000", pairs,
           25088, True, strip_always)
    del pairs
    torch.cuda.empty_cache()
    # 12 reads; the first 8 are the 8 of the rows below.
    pairs = pairs_100k(np.random.default_rng(6), dev, 12)
    for B in (1, 2, 4, 6, 8, 12):
        strip_widths(widths, f"K2 W=65536 B={B}",
                     [x[:B].contiguous() for x in pairs], 65536, False)
    strip_widths(widths, "K4 W=65536 B=1",
                 [x[:1].contiguous() for x in pairs], 65536, True)
    emit({"phase": "1u", "strip_width_ms": widths})
    pairs = [x[:N_ULTRA_READS].contiguous() for x in pairs]
    row_of("K2 strips vs scratch W=65536 B=8 n=100000", pairs, 65536, False,
           scratch_past_cluster)
    row_of("K4 strips vs scratch W=65536 B=1 n=100000",
           [x[:1].contiguous() for x in pairs], 65536, True,
           scratch_past_cluster)
    del pairs
    torch.cuda.empty_cache()
    listing = build.sass()
    issued = {f"{'K4' if p else 'K2'} W={W} B={B}": sass.band_interior_loop(
        listing, sass.plan_needle(bd.band_plan(W, B, p), p), 8)[
            "int_per_cell"] for p, W, B in ((False, 32896, 32),
                                            (True, 32896, 16),
                                            (False, 65536, 8))}
    return {"phase": "1u", "rows": rows, "strip_width_ms": widths,
            "int_ops_per_cell": issued}


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
    for k in ("repeat_counters", "repeat_warm_counters",
              "repeat_cigar_counters"):
        check(repeat[k]["faults"] == 0, f"{k}: a batch raised")
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


def start_cpu_crosscheck(ref, paths, recs, short) -> list:
    """Phase 3's CPU runs of the port (plain versions), started in parallel
    subprocesses: they run beside the GPU phases, and
    finish_cpu_crosscheck holds them to the GPU runs."""
    env = dict(os.environ, BIOINFO1_PLATFORM="cpu", BIOINFO1_BAND_CACHE="0",
               OMP_NUM_THREADS="2")
    jobs = []
    staged = {name for name, _ in short}
    for key, flags, reads, names in (
            ("score", [], paths[N_CPU_READS], None),
            ("c", ["-c"], paths[N_CPU_READS], None),
            ("c_a_local", ["-c", "-a", "local"], paths[N_CPU_LOCAL_READS],
             None),
            ("g1", ["-g", "1"], paths["cpu_staged_fq"], staged),
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
    return jobs


def stop_processes(jobs) -> None:
    """Kills whatever of ``jobs`` (tuples ending in a Popen) still runs."""
    for *_x, proc in jobs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_cpu_crosscheck(jobs, gpu_lines) -> dict:
    """Phase 3: each CPU run of start_cpu_crosscheck held byte for byte to
    the GPU run's lines of the same reads; the seconds are from the
    collection's start."""
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
        stop_processes(jobs)
    return res


def device_time(prof):
    """(busy seconds, top device events) of a torch.profiler run: busy is
    the union of the device intervals; top lists the 12 names with the most
    device time, then any kernel of the port (csrc/) below them, as [name,
    launches, ms]."""
    # The profiler mirrors each record_function scope that launched device
    # work as a device-side annotation spanning that work: not device time.
    scopes = {e.name for e in prof.events() if e.is_user_annotation}
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation and e.name not in scopes]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in ev):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name: dict = {}
    for e in ev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = top[:12] + [kv for kv in top[12:]
                      if any(k in kv[0] for k in PORT_KERNELS)]
    return busy_us / 1e6, [[k, n, us / 1e3] for k, (n, us) in top]


# Kernel function names of csrc/, as a profiler names their launches.
PORT_KERNELS = ("lis_chain_kernel", "band_reg_kernel", "band_scratch_kernel",
                "band_strip_kernel", "band_epoch_kernel",
                "band_epoch_merge_kernel", "full_score_kernel",
                "walk_parents_kernel", "int32_probe_kernel")


def phase_profile(genome: str, recs) -> dict:
    """The map stage alone, with the index resident, for each cell
    (score-only, -c global, score-only -g 1 on the first 512 reads, 50 kb
    score-only): a fresh mapper's first pass (band
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
            "score": profile_cell("score", genome, recs, MapperConfig()),
            "cigar": profile_cell("cigar", genome, recs,
                                  MapperConfig(output_cigar=True)),
            # No certificate: K3 scores every bucket (phase 2g's cell).
            "score_g1": profile_cell("score_g1", genome,
                                     recs[:N_NOCERT_READS],
                                     MapperConfig(gap=1)),
            "longread_50k": profile_cell("longread_50k", genome, recs50,
                                         MapperConfig())}


# The mapper's scopes that run on the main thread (map_records_iter); the
# others run on the batch and split worker threads.
MAIN_SCOPES = ("map", "iter.wait", "format")


def trace_split(split: dict, wall: float) -> dict:
    """A device_trace pass's host time: every scope as [calls, threads,
    inclusive s, exclusive s]; the main thread's "map" wall split into
    waiting for batches, formatting and the rest; and the exclusive seconds
    of the other scopes, summed over the worker threads, beside the
    batches' inclusive seconds ("map_batch", what the workers' scopes
    split)."""
    main = {k: split.get(k, {}).get("incl_s", 0.0) for k in MAIN_SCOPES}
    workers = {k: v["excl_s"] for k, v in split.items()
               if k not in MAIN_SCOPES}
    return {"wall_s": wall,
            "scopes": {k: [v["calls"], v["threads"], v["incl_s"],
                           v["excl_s"]] for k, v in split.items()},
            "main_thread": {"map_s": main["map"],
                            "wait_s": main["iter.wait"],
                            "format_s": main["format"],
                            "other_s": main["map"] - main["iter.wait"]
                            - main["format"]},
            "batch_threads_s": split.get("map_batch", {}).get("incl_s", 0.0),
            "worker_scopes_excl_s": workers,
            "worker_scopes_sum_s": sum(workers.values())}


def profile_cell(cell: str, genome: str, recs, cfg) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper
    from bioinfo1_tpu_torch.utils import tracing
    dev = torch.device("cuda", 0)
    res: dict = {}
    for how in ("plain", "profiled", "traced"):
        mapper = Mapper([("ecoli_like", genome)], cfg, device=dev)
        mapper.device_index()
        for name in ("fresh", "adapted"):
            before = mapper.counters.as_dict()
            paths0 = dict(bd.align_scores_banded.path_launches)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if how == "profiled" else None
            trace_dir = os.path.join(WORK, "traces", f"{cell}_{name}")
            if prof:
                prof.start()
            with (tracing.device_trace(trace_dir, dev) if how == "traced"
                  else contextlib.nullcontext()) as traced:
                timers = tracing.StageTimers(dev)
                t0 = time.perf_counter()
                with timers.stage("map"):
                    mapper.map_records(recs)
                wall = time.perf_counter() - t0
            after = mapper.counters.as_dict()
            check(after["faults"] == 0, f"profile {cell}: a batch raised")
            row = {"wall_s": wall, "reads_per_s": len(recs) / wall,
                   "realign_batches": after["realign_batches"]
                   - before["realign_batches"],
                   "cert_misses": (after["cert_total"] - after["cert_hits"])
                   - (before["cert_total"] - before["cert_hits"]),
                   "counters": {k: after[k] - before.get(k, 0)
                                for k in after if k != "cert_hit_rate"
                                and isinstance(after[k], (int, float))},
                   # K2 / K4 launches by path of ops/band.band_plan.
                   "band_path_launches": {
                       k: v - paths0[k] for k, v in
                       bd.align_scores_banded.path_launches.items()},
                   # The bucket bands the pass ended with: "cap,for_cigar".
                   "bands": {f"{cap},{int(fc)}": band for (cap, fc), band
                             in mapper._band_by_key.items()}}
            if prof:
                prof.stop()
            for p in (prof, traced):
                if p is not None:
                    busy, top = device_time(p)
                    check(busy > 0, "the profiler recorded no device time")
                    row.update(device_busy_s=busy, busy_share=busy / wall,
                               top_device=top)
            if traced is not None:
                row["host"] = trace_split(tracing.host_split(
                    os.path.join(trace_dir, tracing.TRACE_FILE)), wall)
            res[name + ("" if how == "plain" else "_" + how)] = row
        del mapper
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if "--process-worker" in sys.argv[1:]:
        return process_worker(sys.argv[1:])
    started = time.perf_counter()
    profile_map = "--profile-map" in sys.argv[1:]
    lpt_trial = "--lpt-trial" in sys.argv[1:]
    walk_trial = "--walk-trial" in sys.argv[1:]
    chain_profile = "--chain-profile" in sys.argv[1:]
    chain_trial = chain_profile or "--chain-trial" in sys.argv[1:]
    wide_trial = "--wide-trial" in sys.argv[1:]
    parent = (os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
              if "--parent" in sys.argv[1:] else None)
    full_trial = "--full-trial" in sys.argv[1:]
    strip_trial = "--strip-trial" in sys.argv[1:]
    epoch_trial = "--epoch-trial" in sys.argv[1:]
    megabase_trial = "--megabase-trial" in sys.argv[1:]
    split_trial = "--split-trial" in sys.argv[1:]
    shard_trial = "--shard-trial" in sys.argv[1:]
    process_trial = "--process-trial" in sys.argv[1:]
    genome_mb = (int(sys.argv[sys.argv.index("--genome-mb") + 1])
                 if "--genome-mb" in sys.argv[1:] else 0)
    if lpt_trial:
        os.environ["BIOINFO1_NVCC_DEFINES"] = "BIOINFO1_BAND_LPT_TRIAL"
    if chain_profile:
        os.environ["BIOINFO1_NVCC_DEFINES"] = "BIOINFO1_CHAIN_PROFILE"
    if epoch_trial:
        os.environ["BIOINFO1_NVCC_DEFINES"] = "BIOINFO1_BAND_EPOCH_TRIAL"
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
    if walk_trial:
        emit(phase_walk_trial(dev))
        return 0
    if chain_trial:
        emit(phase_chain_trial(dev))
        return 0
    if wide_trial:
        emit(phase_wide_trial(dev, parent))
        return 0
    if full_trial:
        emit(phase_full_trial(dev))
        return 0
    if strip_trial:
        emit(phase_strip_trial(dev))
        return 0
    if epoch_trial or megabase_trial:
        if epoch_trial:
            emit(phase_epoch_trial(dev))
        if megabase_trial:
            emit(phase_megabase_trial(dev, parent))
        return 0
    if split_trial:
        emit(phase_split_trial())
        return 0
    if shard_trial:
        emit(phase_shard_trial())
        if genome_mb:
            emit(phase_shard_big(genome_mb))
        return 0
    if process_trial:
        emit(phase_process_trial())
        return 0
    rows = phase_kernels(dev)
    emit({"phase": 1, "kernels": rows})
    listing = build.sass()
    with open(os.path.join(WORK, "kernels.sass"), "w") as fh:
        fh.write(listing)
    issued = issued_per_unit(listing)
    emit({"phase": "1s", "int_ops_per_unit": issued})
    torch.cuda.empty_cache()
    p2a = phase_golden()
    emit(p2a)

    ref, paths, recs, genome, short = write_inputs()
    p2, score_lines = phase_pipeline(ref, paths[N_READS], recs)
    emit(p2)
    p2c, gpu_lines = phase_cigar(ref, paths, recs)
    emit(p2c)
    p2g, nocert_lines = phase_nocert(ref, paths, recs)
    emit(p2g)
    p2s, staged_lines = phase_staged(ref, paths, recs)
    emit(p2s)
    # Phase 3's CPU runs go beside phases 2d-2r (the CLI phases before them
    # keep the host's cores to themselves); a phase that fails stops them.
    cpu_jobs = start_cpu_crosscheck(ref, paths, recs, short)
    try:
        both = {"score": (score_lines, p2),
                "c": (gpu_lines["c"], p2c["runs"][0])}
        p2d = phase_split(genome, recs, both)
        emit(p2d)
        p2x = phase_shard(genome, recs, both)
        emit(p2x)
        p2p = phase_processes(ref, paths[N_READS], both)
        emit(p2p)
        gpu_lines.update(staged_lines, score=score_lines, **nocert_lines)
        p2l = phase_longread(dev)
        emit(p2l)
        p2u = phase_ultralong(dev)
        emit(p2u)
        emit(phase_c12(dev))
        p2e = phase_megabase(dev, rows)
        emit(p2e)
        p2r = phase_repeat_and_roofline(dev)
        emit(p2r)
        torch.cuda.empty_cache()
        emit(finish_cpu_crosscheck(cpu_jobs, gpu_lines))
    finally:
        stop_processes(cpu_jobs)
    if profile_map:
        emit(phase_profile(genome, recs))

    # Launches on each kernel's own path: the score-only run (phase 2) for
    # K1-K3, the 50 kb run (phase 2L) for K2's cluster path, the 100 kb
    # runs (phase 2U: the planned fresh pass, the -c run) for K2's and K4's
    # strip path, the ~150 kb read's planned fresh pass (phase 2U) for K1's
    # wide path, the megabase read's fresh pass (phase 2E) for K2's
    # "epochs" path, the -c runs (phase 2c) for K4 and K5, the roofline
    # (phase 2r) for K6.
    path_launches = dict(p2["launches"])
    path_launches["band_score_cluster"] = p2l["launches"]["band_score_cluster"]
    path_launches["band_score_strip"] = p2u["launches"]["band_score_strip"]
    path_launches["band_score_epochs"] = p2e["launches"]["band_score_epochs"]
    path_launches["lis_chain_wide"] = p2u["golden"]["launches"][
        "lis_chain_wide"]
    path_launches["band_parents_strip"] = p2u["cigar"]["launches"][
        "band_parents_strip"]
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
                      "golden_launches": p2a["launches"][name],
                      "nocert_launches": p2g["launches"][name],
                      "split_launches": p2d["launches"][name],
                      "shard_launches": p2x["launches"][name],
                      "process_launches": p2p["launches"][name],
                      "staged_launches": p2s["launches"][name],
                      "repeat_launches": p2r["launches"][name],
                      "ultralong_launches": p2u["launches"][name]})
    emit({"phase": "end", "wall_s": time.perf_counter() - started})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
