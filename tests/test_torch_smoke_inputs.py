"""chip_smoke.py's ONT-profile data, its bounds and its profile reader,
checked here on the CPU.

The smoke draws its genome and reads with the port's simulator
(bioinfo1_tpu_torch/utils/simulate.py), which must draw exactly what
bioinfo1_tpu/utils/simulate.py draws from the same seed, so they are the
ones the JAX package's tests and tools use.  The smoke also imports no JAX
and, with no CUDA device, exits non-zero before printing a result.
"""

import importlib.util
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bioinfo1_tpu.utils import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 20250817])
def test_random_genome_matches_simulate(smoke, seed):
    got = smoke.sim.random_genome(50_000, np.random.default_rng(seed))
    want = simulate.random_genome(50_000, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 7, 99])
def test_mutate_read_matches_simulate(smoke, seed):
    frag = simulate.random_genome(6000, np.random.default_rng(seed + 1000))
    got = smoke.sim.mutate_read(frag, np.random.default_rng(seed))
    want = simulate.mutate_read(frag, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


def test_simulate_reads_matches_simulate(smoke):
    genome = simulate.random_genome(200_000, np.random.default_rng(5))
    lengths = [200, 500, 2000, 4000, 8000, 350, 2000, 4000]
    got = smoke.sim.simulate_reads(genome, lengths, np.random.default_rng(6))
    want = simulate.simulate_reads(genome, lengths, np.random.default_rng(6))
    assert got == want


def test_bound_takes_the_larger_of_bytes_and_operations(smoke):
    row = {"bytes": 3.35e9, "work": 10**9}
    assert smoke.bound(row, 0) == (1.0, "bytes")
    ms, by = smoke.bound(row, 67)
    assert by == "operations" and abs(ms - 2.0) < 1e-9


def test_band_work_counts_matrix_cells_not_swept_lanes(smoke):
    """The bound's work is what the function needs (cells of the matrix
    inside the band); the lanes the kernel sweeps stand beside it."""
    q = torch.zeros((3, 128), dtype=torch.uint8)
    t = torch.zeros((3, 512), dtype=torch.uint8)
    ql = torch.tensor([128, 32, 0], dtype=torch.int32)
    tl = torch.tensor([300, 40, 0], dtype=torch.int32)
    row = smoke.band_work(q, ql, t, tl, 128, False)
    # Pair 0: the target is cut at m_eff = 256; rows i see j from
    # max(1, i - 128) to min(256, i + 127).  Pair 1 lies wholly in the band.
    want = sum(min(256, i + 127) - max(1, i - 128) + 1
               for i in range(1, 129)) + 32 * 40
    assert row["work"] == want and row["unit"] == "cells"
    assert row["swept"] == ((128 + 256 - 1) + (32 + 40 - 1)) * 128
    assert row["swept"] > row["work"]
    with_parents = smoke.band_work(q, ql, t, tl, 128, True)
    assert with_parents["bytes"] == row["bytes"] + (want + 3) // 4
    assert set(smoke.NEEDED_OPS) == set(smoke.KERNELS)


def test_full_work_counts_matrix_cells_and_swept_strips(smoke,
                                                        monkeypatch):
    """K3's bound counts the cells inside each matrix; beside it, the
    cells its strips visit: S lanes on each diagonal r0 + 2 .. min(r0 + S,
    q_len) + t_len of every strip, in whole pairs of diagonals, none on a
    read with q_len = 0 or t_len = 0."""
    from bioinfo1_tpu_torch.ops import align as al
    monkeypatch.setattr(al, "FULL_LPT", 16)
    q = torch.zeros((4, 600), dtype=torch.uint8)
    t = torch.zeros((4, 800), dtype=torch.uint8)
    ql = torch.tensor([600, 0, 513, 40], dtype=torch.int32)
    tl = torch.tensor([700, 5, 0, 31], dtype=torch.int32)
    row = smoke.full_work(q, ql, t, tl)
    assert row["work"] == 600 * 700 + 40 * 31 and row["unit"] == "cells"
    assert row["bytes"] == 4 * 600 + 4 * 800 + 20 * 4
    # Read 0: strips of 512 and 88 rows (1,211 and 787 diagonals, rounded
    # up to pairs); read 3: one strip, 70 diagonals.
    assert row["swept"] == 512 * (1212 + 788 + 70)
    assert (row["lpt"], row["strip_rows"], row["strips"]) == (16, 512, 2)


def test_walk_chain_replays_the_bytes_a_walk_reads(smoke):
    """The host replay of a walk from its codes: its steps are the codes
    before the first done, and it touches one parent row per 4 diagonals
    at most, and a step reads a new 32-byte sector when it changes row or
    crosses a sector boundary in its row."""
    from bioinfo1_tpu_torch.ops import trace as tr
    S4, B, W = 8, 2, 128
    # Read 1 from (10, 9): 3 M, 1 I, 2 D, 1 M, then done.
    codes = np.full((4 * (S4 + 1), B), tr.OP_DONE, np.uint8)
    codes[:7, 1] = [0, 0, 0, 1, 2, 2, 0]
    packed = tr.pack_codes(torch.from_numpy(codes)).numpy()
    got = smoke.walk_chain(packed, 1, 10, 9, S4, B, W)
    assert got["steps"] == 7
    # Diagonals 19, 17, 15, 13, 12, 11, 10: rows 4, 3, 3, 2, 2, 2, 2, lane
    # 63 but for the last (64: the next sector of row 2).
    assert got["rows"] == 3 and got["lane_span"] == 1
    assert got["sectors"] == got["sector_changes"] == 4
    assert smoke.walk_chain(packed, 0, 5, 5, S4, B, W) == {"steps": 0}


def test_chain_work_counts_window_pairs(smoke):
    """K1's work is its window pairs (j < i, f_i - 5000 < f_j < f_i), on
    sorted rows (by search) and unsorted ones alike; ``swept`` is what its
    cross phase tests: 32 x 32 pairs for each chunk of [q_lo, k)."""
    from bioinfo1_tpu_torch.ops import chain as ch
    rng = np.random.default_rng(3)
    f = np.sort(rng.integers(1, 12000, (3, 200)), axis=1).astype(np.int32)
    f[2] = rng.permutation(f[2])
    f[1, 50:60] = f[1, 50]                 # a run of equal f
    cnt = np.array([0, 200, 150], np.int32)
    want, swept = 0, 0
    for b in range(3):
        x = f[b, :cnt[b]].astype(np.int64)
        want += sum(int(((x[:i] > x[i] - 5000) & (x[:i] < x[i])).sum())
                    for i in range(len(x)))
        q_lo = ch.chunk_q_lo(x, len(x))
        swept += 1024 * int((np.arange(len(q_lo)) - q_lo).sum())
    got = smoke.chain_work(*(torch.from_numpy(x) for x in (f, f, cnt)))
    assert got["work"] == want > 0
    assert got["swept"] == swept > 0
    assert got["all_pairs"] == 200 * 199 // 2 + 150 * 149 // 2
    assert (got["longest_row"], got["bytes"]) == (200, 8 * 350 + 24 * 3)


def test_wide_trial_finds_the_scan_start_in_k1(smoke):
    """--wide-trial times K1's prologue without the wide path's q_lo scan
    start by replacing one line of csrc/lis_chain.cu: that line is there
    once, and the counters it reads are the measurement build's nine."""
    with open(os.path.join(REPO, "bioinfo1_tpu_torch", "csrc",
                           "lis_chain.cu")) as fh:
        src = fh.read()
    assert src.count(smoke.SCAN_START) == 1
    assert "g_chain_profile[9]" in src
    assert len(smoke.CHAIN_PROFILE_COUNTERS) == 9


def test_device_time_merges_overlapping_intervals(smoke):
    """Busy time is the union of the kernels' intervals; a record_function
    scope, on the host or mirrored on the device as an annotation spanning
    the kernels it launched, is no device time."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU

    def ev(name, start, end, dev=cuda, annotation=False):
        rng = SimpleNamespace(start=start, end=end,
                              elapsed_us=lambda: end - start)
        return SimpleNamespace(name=name, device_type=dev, time_range=rng,
                               is_user_annotation=annotation)

    prof = SimpleNamespace(events=lambda: [
        ev("k2", 0.0, 100.0), ev("k2", 50.0, 120.0), ev("k1", 200.0, 210.0),
        ev("host_op", 0.0, 1000.0, cpu), ev("k3", 205.0, 208.0),
        ev("map_batch", 0.0, 900.0, cpu, annotation=True),
        ev("map_batch", 0.0, 210.0)])
    busy, top = smoke.device_time(prof)
    assert busy == 130.0 / 1e6
    assert top == [["k2", 2, 0.17], ["k1", 1, 0.01], ["k3", 1, 0.003]]
    # Past the 12 largest, the port's own kernels still show.
    many = [ev(f"op{n}", 300.0 + n, 301.0 + n + n) for n in range(14)]
    k1 = ev("void lis_chain_kernel<0>(int const*)", 400.0, 400.5)
    _, top = smoke.device_time(SimpleNamespace(events=lambda: many + [k1]))
    assert len(top) == 13 and top[-1][0] == k1.name


def test_parents_err_chunked_counts_cells_that_differ(smoke):
    """The 50 kb rows compare parent tensors chunk by chunk: a change of a
    cell inside a read's matrix counts, a change outside it does not, and
    the chunks see the cells the whole tensor shows."""
    from bioinfo1_tpu_torch.ops import band as bd
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 256, (40, 3, 128)).astype(np.uint8))
    ql = torch.tensor([100, 50, 0], dtype=torch.int32)
    tl = torch.tensor([120, 60, 5], dtype=torch.int32)
    assert smoke.parents_err_chunked(a, a.clone(), ql, tl, 256, rows=7) == 0
    inside = bd.parent_cells(a, ql, tl, 256) != 255
    b = a.clone()
    b[30, 1] = 0          # diagonals 122-125: past read 1's last (110)
    b[:, 2] = 0           # read 2 has no cell
    assert smoke.parents_err_chunked(a, b, ql, tl, 256, rows=7) == 0
    d, lane = 4 * 20 + 2, 64  # diagonal 82, lane 64 of read 0: i = 41
    assert inside[d - 2, 0, lane]
    b[20, 0, lane] ^= 0xff
    err = smoke.parents_err_chunked(a, b, ql, tl, 256, rows=7)
    assert err == int((bd.parent_cells(a, ql, tl, 256)
                       != bd.parent_cells(b, ql, tl, 256)).sum()) >= 1


def test_path_counts_reset_with_the_kernel_counts(smoke):
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.ops import chain as ch
    counts = bd.align_scores_banded.path_launches
    chain_counts = ch.lis_chain.path_launches
    assert set(counts) == set(bd.PATHS)
    assert set(chain_counts) == set(ch.CHAIN_PATHS)
    counts["cluster"], counts["scratch"] = 5, 2
    chain_counts["wide"], chain_counts["state"] = 4, 1
    counters = smoke.reset_launches()
    assert set(counters) == set(smoke.KERNELS)
    assert all(v == 0 for v in counts.values())
    assert all(v == 0 for v in chain_counts.values())
    for name, path, held in (("band_score_cluster", "cluster", counts),
                             ("lis_chain_wide", "wide", chain_counts)):
        wrapper, attr = counters[name]
        held[path] = 3
        assert getattr(wrapper, attr) == 3
        setattr(wrapper, attr, 0)
        assert held[path] == 0


def test_smoke_imports_no_jax_and_fails_without_cuda():
    code = ("import runpy, sys\n"
            "sys.argv = ['chip_smoke.py']\n"
            "try:\n"
            "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m.startswith('bioinfo1_tpu.')"
            " or m == 'bioinfo1_tpu']\n"
            "print('RC', rc, 'BAD', bad)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "RC 1 BAD []", proc.stdout


def test_band_plan_as_swaps_the_plan_and_restores_it(smoke):
    """Phase 2U's control (scratch past W_CLUSTER) and the strip trial's
    plan (strips for every band) replace ops/band.band_plan for their
    body only; below W_CLUSTER the control keeps the real plan."""
    from bioinfo1_tpu_torch.ops import band as bd
    planned = bd.band_plan
    with smoke.band_plan_as(smoke.scratch_past_cluster):
        assert bd.band_plan(65536, 8, False).path == "scratch"
        assert bd.band_plan(32896, 1, True).path == "scratch"
        assert bd.band_plan(25088, 11, False).path == "cluster"
        assert bd.band_plan(256, 11, False).path == "warp"
    assert bd.band_plan is planned
    with pytest.raises(KeyError):
        with smoke.band_plan_as(smoke.strip_always):
            plan = bd.band_plan(25088, 11, False)
            assert plan.path == "strip"
            assert plan.strips == -(-25088 // plan.strip)
            raise KeyError
    assert bd.band_plan is planned
    assert bd.band_plan(65536, 8, False).path == "strip"
    # The trial's fixed widths: strips of S lanes where the plan takes
    # strips, the real plan elsewhere.
    for S in bd.STRIP_WIDTHS:
        with smoke.band_plan_as(smoke.strip_width(S)):
            assert bd.band_plan(65536, 8, False, bd.H100_SXM).strip == S
            assert bd.band_plan(25088, 11, False).path == "cluster"
    assert bd.band_plan is planned


def test_epochs_past_cluster_forces_k2_alone(smoke):
    """Phase 2U's forced route (epochs_past_cluster) sends every score-only
    band past W_CLUSTER to K2's "epochs" path and leaves K4 and the bands
    up to W_CLUSTER as planned; the epoch trial's plan (epochs_at) names
    its strip width and halo; both only for their body."""
    from bioinfo1_tpu_torch.ops import band as bd
    planned = bd.band_plan
    with smoke.band_plan_as(smoke.epochs_past_cluster):
        assert bd.band_plan(32896, 1, False) == bd.epoch_plan(32896)
        assert bd.band_plan(65536, 8, False).path == "epochs"
        assert bd.band_plan(65536, 1, True).path == "strip"
        assert bd.band_plan(bd.W_STRIP + 128, 1, True).path == "scratch"
        assert bd.band_plan(32768, 1, False).path == "cluster"
        assert bd.band_plan(256, 11, False).path == "warp"
    assert bd.band_plan is planned
    with smoke.band_plan_as(smoke.epochs_at(1024, 32)):
        plan = bd.band_plan(4224, 3, False)
        assert (plan.path, plan.strip, plan.halo, plan.strips) == (
            "epochs", 1024, 32, 5)
    assert bd.band_plan is planned


def test_megabase_read_is_the_pinned_recipe(smoke):
    """Phase 2E's read: tests/torch_golden_mb.json's recipe (the bench's
    genome, one ONT-profile read of a fragment of MB_FRAGMENT bases from
    default_rng(SEED + MB_SEED_OFFSET)) gives a read of the pinned length
    in the 1,572,864 length bucket, whose adapted fused band (at most cap
    / 2 = 786,432) and realign band (2^20) both lie past an H100 SXM's
    w_strip: K2's "epochs" path on both."""
    import json

    import bench_torch
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.pipeline import mapper as mp
    with open(smoke.GOLDEN_MB) as fh:
        pin = json.load(fh)
    assert pin["recipe"] == {"genome": "bench_torch.make_data("
                                       "bench_torch.FULL)",
                             "reads_seed": bench_torch.SEED
                             + smoke.MB_SEED_OFFSET,
                             "fragment": smoke.MB_FRAGMENT}
    assert len(pin["sha256"]) == 64 and pin["pinned_by"]
    _, recs = smoke.megabase_records()
    assert len(recs) == 1 and len(recs[0][1]) == pin["read_len"]
    cap = mp._bucket_cap(pin["read_len"])
    assert cap == 1572864
    assert bd.W_STRIP < smoke.W_PAST_STRIP <= cap // 2 < smoke.W_MB
    for W in (smoke.W_PAST_STRIP, cap // 2, smoke.W_MB):
        assert bd.band_plan(W, 1, False).path == "epochs"
        assert bd.band_plan(W, 1, True).path == "scratch"


def test_cigar_score_rescores_the_mappers_cigars(smoke):
    """Phase 2U's -c check on the CPU: every CIGAR of a -c run spans its PAF
    line's extents (M + D query bases, M + I target bases) and
    ``cigar_score`` over the mapper's region strings gives the read's
    score, which is the score-only run's."""
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    genome = simulate.random_genome(60_000, np.random.default_rng(11))
    recs = simulate.simulate_reads(genome, (2000, 3000, 2500),
                                   np.random.default_rng(12))
    ref = genome.tobytes().decode("latin1")
    seqs = [s for _, s in recs]
    cpu = torch.device("cpu")
    scores = [m.score for m in Mapper([("g", ref)], MapperConfig(),
                                      device=cpu).map_batch(seqs)]
    mapper = Mapper([("g", ref)], MapperConfig(output_cigar=True),
                    device=cpu)
    lines = mapper.map_records(recs)
    mapped = mapper.map_batch(seqs)
    assert len(lines) == len(recs)
    for line, m, seq, want in zip(lines, mapped, seqs, scores):
        f = line.split("\t")
        cig = next(x[5:] for x in f if x.startswith("cg:Z:"))
        span = smoke.cigar_spans(cig)
        assert m.cigar == cig and span["I"] + span["D"] > 0
        assert span["M"] + span["D"] == int(f[3]) - int(f[2])
        assert span["M"] + span["I"] == int(f[8]) - int(f[7])
        q, t = mapper._region_strings(seq, m.q_begin, m.q_end, m.t_begin,
                                      m.t_end, m.is_fwd)
        cfg = mapper.cfg
        assert smoke.cigar_score(cig, q, t, m.target_begin or 0, cfg.match,
                                 cfg.mismatch, cfg.gap) == m.score == want
