"""CUDA kernels of the port against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips (in a fixture, at run time) when torch
sees no CUDA device.  On a machine with one, run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the repository's conftest configures JAX, which the
port and this file do not need).  Comparisons are exact: integer outputs,
tolerance 0.  Banded parents are compared on the cells they are defined on
(ops/band.parent_cells); walk codes and CIGARs on every read the strict
certificate passes, or on all reads where both walks get the same parents.
"""

import dataclasses
import io
import threading

import numpy as np
import pytest
import torch

from bioinfo1_tpu_torch.index import builder
from bioinfo1_tpu_torch.ops import align as al
from bioinfo1_tpu_torch.ops import band as bd
from bioinfo1_tpu_torch.ops import chain as ch
from bioinfo1_tpu_torch.ops import probe
from bioinfo1_tpu_torch.ops import trace as tr
from bioinfo1_tpu_torch.pipeline import device_map as dm
from bioinfo1_tpu_torch.utils import simulate
from torch_chain_rows import (TIE_J1, WIDE_COLINEAR_N, WIDE_ROWS, batch,
                              colinear_rows)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same(got, want):
    for f in got.__dataclass_fields__:
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
            continue
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      getattr(want, f).cpu().numpy(),
                                      err_msg=f)


def _chain_rows(rng, R, N, most=None):
    """R rows of budget N, counts drawn up to N (at most ``most``: the plain
    version loops over the count), row 0 empty, row 1 full."""
    f = np.zeros((R, N), np.int32)
    r = np.zeros((R, N), np.int32)
    cnt = rng.integers(0, N + 1, R).astype(np.int32)
    cnt[0], cnt[1] = 0, N
    if most is not None:
        cnt = np.minimum(cnt, most)
    span = max(4 * min(N, most or N), 20000)
    for b in range(R):
        n = int(cnt[b])
        fs = np.sort(rng.integers(1, span, n)).astype(np.int32)
        rs = fs + rng.integers(0, 3, n).astype(np.int32) * (4999 + b % 2)
        f[b, :n], r[b, :n] = fs, np.maximum(rs, 1)
    return f, r, cnt


@pytest.mark.parametrize("R,N", [(8, 128), (32, 1536), (8, 4096),
                                 (4, 20480)])
def test_lis_chain_kernel_matches_plain(dev, R, N):
    f, r, cnt = (torch.from_numpy(x).to(dev)
                 for x in _chain_rows(np.random.default_rng(N), R, N))
    _same(ch.lis_chain(f, r, cnt), ch.lis_chain_plain(f, r, cnt))


def test_lis_chain_kernel_from_several_threads(dev):
    """The mapper launches K1 from several worker threads at different match
    budgets: a thread's shared-memory opt-in must hold when another thread
    opts the same kernel in for less just before the launch."""
    jobs = []
    for R, N in ((4, 128), (2, 16384), (4, 256), (2, 12288)):
        f, r, cnt = _chain_rows(np.random.default_rng(N), R, N)
        cnt = np.minimum(cnt, 24)       # short rows: the launches dominate
        f, r, cnt = (torch.from_numpy(x).to(dev) for x in (f, r, cnt))
        jobs.append((f, r, cnt, ch.lis_chain_plain(f, r, cnt)))
    torch.cuda.synchronize(dev)
    start = threading.Barrier(len(jobs))
    errors = []

    def run(f, r, cnt, want):
        try:
            start.wait()
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for _ in range(4000):
                    got = ch.lis_chain(f, r, cnt)
                _same(got, want)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors


def _chain_once(f, r, cnt):
    """K1 on (f, r, cnt), held to the plain version bit for bit; it must
    launch exactly once."""
    before = ch.lis_chain.launches
    got = ch.lis_chain(f, r, cnt)
    torch.cuda.synchronize()
    assert ch.lis_chain.launches == before + 1
    _same(got, ch.lis_chain_plain(f, r, cnt))
    return got


# Small budgets, the last N of each ops/chain.chain_plan path and the first
# of the next, the mapper's 50 kb budget (36,864), the largest narrow
# budgets and the wide path's first and the 196,608 bucket's base budget;
# past 2,097,152 (65,536 chunks: the old wide path's 16-bit chunk index)
# rows of at most 20,000 matches.
@pytest.mark.parametrize("N,path", [
    (1, "shared"), (31, "shared"), (32, "shared"), (33, "shared"),
    (1000, "shared"), (16000, "shared"), (16001, "state"),
    (36864, "state"), (37152, "state"), (37153, "scratch"),
    (40000, "scratch"), (65535, "scratch"), (65536, "wide"),
    (73728, "wide"), (2097153, "wide"), (4194304, "wide")])
def test_lis_chain_kernel_every_path(dev, N, path):
    assert ch.chain_plan(N).path == path
    R = 6 if N <= 1000 else 2
    most = 20000 if N > 2 ** 21 else None
    f, r, cnt = (torch.from_numpy(x).to(dev)
                 for x in _chain_rows(np.random.default_rng(N + 1), R, N,
                                      most))
    _chain_once(f, r, cnt)


def _special_chain_rows(case, N):
    """Rows of <= 96 matches in a budget of N (so every chain_plan path
    runs them): unsorted f, an all-empty batch, one row, runs of equal f,
    and earliest-j ties across a chunk boundary (column 40 from 3 in the
    cross phase and 35 in its own chunk; column 70 from 10 and 50, two
    warps' chunks); elsewhere r falls as f rises, so nothing chains."""
    rng = np.random.default_rng(len(case))
    f = np.zeros((4, N), np.int32)
    r = np.zeros((4, N), np.int32)
    cnt = np.full(4, 96, np.int32)
    n = 96
    if case == "unsorted":
        f[:, :n] = rng.integers(1, 20000, (4, n))
        r[:, :n] = f[:, :n] + rng.integers(0, 3, (4, n)) * 4999
    elif case == "empty_batch":
        f[:, 0], r[:, 0] = 7, 9
        cnt[:] = 0
    elif case == "one_row":
        f, r, _ = _chain_rows(rng, 2, N)
        return f[1:], r[1:], np.array([min(N, 96)], np.int32)
    elif case == "equal_f":
        f[:, :n] = np.repeat(1 + 900 * np.arange(n), 12)[:n]
        r[:, :n] = f[:, :n] + rng.integers(0, 800, (4, n))
    else:                                       # cross_chunk_tie
        f[:, :n] = 10 + np.arange(n)
        r[:, :n] = 1_000_000 - 100 * np.arange(n)
        r[0, [3, 35, 40]] = (100, 100, 200)
        r[1, [10, 50, 70]] = (1000, 1000, 1100)
    return f, r, cnt


@pytest.mark.parametrize("N", [96, 20000, 40000, 70000])
@pytest.mark.parametrize("case", ["unsorted", "empty_batch", "one_row",
                                  "equal_f", "cross_chunk_tie"])
def test_lis_chain_kernel_special_rows(dev, case, N):
    f, r, cnt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in _special_chain_rows(case, N))
    got = _chain_once(f, r, cnt)
    if case == "cross_chunk_tie":
        assert got.length[:2].tolist() == [2, 2]
        assert got.q_start[:2].tolist() == [13, 20]
    if case == "empty_batch":
        assert got.length.tolist() == [0] * 4
        assert got.q_start.tolist() == [7] * 4


@pytest.mark.parametrize("case", list(WIDE_ROWS))
def test_lis_chain_wide_kernel_past_the_16_bit_index(dev, case):
    """K1's wide path where lis and the chosen j pass 65,535 (a colinear
    run of 70,000), on an earliest-j tie across a chunk boundary at j >
    65,535, and on counts 65,535-65,537 in one batch."""
    f, r, cnt = (torch.from_numpy(x).to(dev)
                 for x in batch(WIDE_ROWS[case]()))
    assert ch.chain_plan(f.shape[1]).path == "wide"
    got = _chain_once(f, r, cnt)
    if case == "colinear":
        assert got.length.tolist() == [70000]
    if case == "tie":
        assert got.q_start.tolist() == [10 + TIE_J1]


@pytest.mark.parametrize("R,N", [(8, 128), (32, 1536), (8, 4096)])
def test_lis_chain_wide_path_at_small_budgets(dev, monkeypatch, R, N):
    """The wide instantiation takes any budget (the plan sends it only
    those past 65,535): forced at small ones, on phase-1 style rows and
    the special rows, it equals the plain version."""
    planned = ch.chain_plan
    monkeypatch.setattr(ch, "chain_plan", lambda n: dataclasses.replace(
        planned(n), path="wide"))
    f, r, cnt = (torch.from_numpy(x).to(dev)
                 for x in _chain_rows(np.random.default_rng(N + 2), R, N))
    _chain_once(f, r, cnt)
    for case in ("unsorted", "equal_f", "cross_chunk_tie"):
        f, r, cnt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in _special_chain_rows(case, max(N, 96)))
        _chain_once(f, r, cnt)


def test_lis_chain_wide_kernel_past_the_16_bit_chunk_index(dev):
    """A colinear row of 2,200,000 matches (68,750 chunks, q_lo past
    65,535): each match's unique best predecessor is the one before it, so
    the chain is the whole row, from j = 0 to the last (the O(N^2) plain
    version is out of reach here)."""
    f, r, cnt = (torch.from_numpy(x).to(dev)
                 for x in batch(colinear_rows(WIDE_COLINEAR_N)))
    n = WIDE_COLINEAR_N
    assert ch.chain_plan(f.shape[1]).path == "wide" and n > 2 ** 21
    before = ch.lis_chain.path_launches["wide"]
    got = ch.lis_chain(f, r, cnt)
    torch.cuda.synchronize()
    assert ch.lis_chain.path_launches["wide"] == before + 1
    assert [getattr(got, k).tolist() for k in
            ("length", "q_start", "q_end", "t_start", "t_end")] == \
        [[n], [1], [n], [1], [n]]


def test_lis_chain_refuses_budgets_past_the_wide_limit(dev):
    f = torch.zeros((1, ch._MAX_N + 1), dtype=torch.int32, device=dev)
    before = ch.lis_chain.launches
    with pytest.raises(ValueError, match="outside"):
        ch.lis_chain(f, f, torch.ones(1, dtype=torch.int32, device=dev))
    assert ch.lis_chain.launches == before


def _pairs(rng, B, n, m, dev):
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(n // 4, n + 1))
        tgt = simulate.random_genome(min(m, int(ln * 1.3) + 8), rng)
        qry = simulate.mutate_read(tgt[:ln], rng)[:n]
        if b % 5 == 0:
            tgt = simulate.random_genome(m, rng)
        qa[b, :len(qry)], ql[b] = qry, len(qry)
        ta[b, :len(tgt)], tl[b] = tgt, len(tgt)
        if b % 4 == 1:
            qa[b, 3], ta[b, 7] = ord("-"), ord("-")
    ql[-1] = tl[-1] = 0
    return [torch.from_numpy(x).to(dev) for x in (qa, ql, ta, tl)]


# Every path of band_plan: one warp, several warps, a cluster (W = 19,968:
# 6 CTAs of 416 threads), strips (W = 32,896: 9 strips of 4,096 lanes).
BANDS = [128, 256, 512, 1024, 4096, 19968, 32896]


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_kernel_matches_plain(dev, mode, band):
    q, ql, t, tl = _pairs(np.random.default_rng(mode), 12, 600, 900, dev)
    for dash_free in (False, True):
        args = (q, ql, t, tl, 1, -1, -1)
        _same(bd.align_scores_banded(*args, band=band, mode=mode,
                                     dash_free=dash_free),
              bd.align_scores_banded_plain(*args, band=band, mode=mode,
                                           dash_free=dash_free))


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_parents_kernel_matches_plain(dev, mode, band):
    q, ql, t, tl = _pairs(np.random.default_rng(10 + mode), 12, 600, 900,
                          dev)
    m_eff = bd.band_shapes(600, 900, band)[2]
    for dash_free in (False, True):
        args = (q, ql, t, tl, 1, -1, -1)
        got = bd.align_scores_banded(*args, band=band, mode=mode,
                                     dash_free=dash_free, want_parents=True)
        want = bd.align_scores_banded_plain(*args, band=band, mode=mode,
                                            dash_free=dash_free,
                                            want_parents=True)
        for f in ("score", "goal_i", "goal_j"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(bd.parent_cells(got.parents, ql, tl, m_eff),
                           bd.parent_cells(want.parents, ql, tl, m_eff))
        # The walk kernel against the plain walk on the same parents.
        walk_args = (got.parents, got.goal_i, got.goal_j, got.score, q, t,
                     1, -1, -1, mode)
        assert torch.equal(tr.walk_parents(*walk_args),
                           tr.walk_parents_plain(*walk_args))


def _tie_pairs(rng, B, n, m, dash, dev):
    """Tie-heavy pairs over a two-letter alphabet, NUL-padded: 10% of the
    target bytes flipped, optional '-' bytes, and rows with an empty
    query, an empty target, both empty, a 1-tall and a 1-wide matrix and
    the full widths (all of them shorter than most bands)."""
    letters = np.frombuffer(b"AC", np.uint8)
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = rng.integers(1, n + 1, B).astype(np.int32)
    tl = rng.integers(1, m + 1, B).astype(np.int32)
    special = [(n, m), (0, 0), (1, m), (n, 1), (0, 5), (7, 0)]
    for b, (x, y) in enumerate(special[:B]):
        ql[b], tl[b] = x, y
    for b in range(B):
        base = letters[rng.integers(0, 2, max(ql[b], tl[b]) + 1)]
        qa[b, :ql[b]] = base[:ql[b]]
        tgt = base[:tl[b]].copy()
        flip = rng.random(tl[b]) < 0.1
        tgt[flip] = letters[rng.integers(0, 2, int(flip.sum()))]
        ta[b, :tl[b]] = tgt
        if dash and b % 2 == 0 and ql[b] and tl[b]:
            qa[b, rng.integers(0, ql[b], 2)] = ord("-")
            ta[b, rng.integers(0, tl[b], 2)] = ord("-")
    return [torch.from_numpy(x).to(dev) for x in (qa, ql, ta, tl)]


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("band", [128, 256, 640, 4224, 8320])
@pytest.mark.parametrize("scoring", [(1, -1, 0), (1, -1, 1), (1, -1, -1)])
def test_band_kernels_on_tie_heavy_pairs(dev, scoring, band, B):
    """Local goal ties and semiGlobal rim ties: a per-thread best reduced
    once must pick what the per-diagonal rules pick.  W = 640 runs a short
    last warp; W = 4,224 and 8,320 run clusters of 2 and 4 CTAs (264 and
    260 threads: short last warps), reduced across ranks."""
    rng = np.random.default_rng(100 * band + B)
    m_eff = bd.band_shapes(500, 800, band)[2]
    for dash in (False, True):
        q, ql, t, tl = _tie_pairs(rng, B, 500, 800, dash, dev)
        args = (q, ql, t, tl, *scoring)
        for mode in (0, 1, 2):
            for dash_free in ((False,) if dash else (False, True)):
                kw = dict(band=band, mode=mode, dash_free=dash_free)
                _same(bd.align_scores_banded(*args, **kw),
                      bd.align_scores_banded_plain(*args, **kw))
                got = bd.align_scores_banded(*args, **kw, want_parents=True)
                want = bd.align_scores_banded_plain(*args, **kw,
                                                    want_parents=True)
                for f in ("score", "goal_i", "goal_j"):
                    assert torch.equal(getattr(got, f), getattr(want, f)), \
                        (f, mode, dash, dash_free)
                assert torch.equal(
                    bd.parent_cells(got.parents, ql, tl, m_eff),
                    bd.parent_cells(want.parents, ql, tl, m_eff)), \
                    (mode, dash, dash_free)


def _crossing_pairs(rng, B, n, m, lead, dev):
    """Pairs whose optimal path wanders over a band of lanes: ONT-profile
    reads of a target that starts with ``lead`` extra bases (the path sits
    near lane W / 2 + lead / 2), each with a 150-base insertion and, later,
    a 250-base deletion (it drifts ~75 lanes down, then ~125 up)."""
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(n // 2, n - 200))
        g = simulate.random_genome(ln + 300, rng)
        a, c = ln // 3, 2 * ln // 3
        body = np.concatenate([g[:a], simulate.random_genome(150, rng),
                               g[a:c], g[c + 250:ln + 250]])
        qry = simulate.mutate_read(body, rng)[:n]
        tgt = np.concatenate([simulate.random_genome(lead, rng),
                              g[:ln + 250]])[:m]
        qa[b, :len(qry)], ql[b] = qry, len(qry)
        ta[b, :len(tgt)], tl[b] = tgt, len(tgt)
        if b % 3 == 1:
            qa[b, 5], ta[b, 9] = ord("-"), ord("-")
    return [torch.from_numpy(x).to(dev) for x in (qa, ql, ta, tl)]


def _cluster_case(dev, q, ql, t, tl, band, mode, dash_free, scoring):
    """K2 and K4 on the cluster path against the plain version."""
    assert bd.band_plan(band, q.shape[0], False).path == "cluster"
    m_eff = bd.band_shapes(q.shape[1], t.shape[1], band)[2]
    args = (q, ql, t, tl, *scoring)
    kw = dict(band=band, mode=mode, dash_free=dash_free)
    before = bd.align_scores_banded.path_launches["cluster"]
    _same(bd.align_scores_banded(*args, **kw),
          bd.align_scores_banded_plain(*args, **kw))
    got = bd.align_scores_banded(*args, **kw, want_parents=True)
    want = bd.align_scores_banded_plain(*args, **kw, want_parents=True)
    assert bd.align_scores_banded.path_launches["cluster"] == before + 2
    for f in ("score", "goal_i", "goal_j"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(bd.parent_cells(got.parents, ql, tl, m_eff),
                       bd.parent_cells(want.parents, ql, tl, m_eff))


# W = 4,224 (2 CTAs of 264 threads), 8,192 (2 x 512), 8,320 (4 x 260),
# 24,576 (6 x 512), 32,768 (8 x 512): with an even cluster a CTA boundary
# sits at lane W / 2, the main diagonal.
CLUSTER_BANDS = [4224, 8192, 8320, 24576, 32768]


@pytest.mark.parametrize("band", CLUSTER_BANDS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_cluster_kernels_match_plain(dev, mode, band):
    """Paths that cross the CTA boundary at the main diagonal both ways."""
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(band + mode), 6,
                                   1800, 2400, 0, dev)
    for dash_free in (False, True):
        _cluster_case(dev, q, ql, t, tl, band, mode, dash_free, (1, -1, -1))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_cluster_kernels_odd_cluster(dev, mode):
    """W = 25,088, the 50 kb reads' band: 7 CTAs of 448 threads, no
    boundary at W / 2; a 3,700-base lead puts the path across the boundary
    at lane 14,336 (rank 3 | rank 4)."""
    assert bd.band_plan(25088, 1, False).segments()[4][0] == 14336
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(7 + mode), 4,
                                   1800, 6000, 3700, dev)
    for dash_free in (False, True):
        _cluster_case(dev, q, ql, t, tl, 25088, mode, dash_free, (1, -1, -1))


def test_band_cluster_more_clusters_than_the_card_holds(dev):
    """B = 40 at W = 24,576: 240 CTAs of 512 threads, more than K4 (one CTA
    per SM) holds at once: the clusters run in waves."""
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(40), 40, 1200,
                                   1600, 0, dev)
    for mode in (0, 1, 2):
        _cluster_case(dev, q, ql, t, tl, 24576, mode, True, (1, -1, -1))


def test_band_cluster_refused_launch_raises(dev, monkeypatch):
    """A cluster the launcher refuses (16 CTAs: past the portable size)
    raises in the wrapper; nothing falls back to another path."""
    plan = bd.band_plan(32768, 1, False)
    monkeypatch.setattr(bd, "band_plan",
                        lambda W, B, p, card=None: dataclasses.replace(
                            plan, cluster=16, threads_per_cta=256))
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(1), 2, 600, 800, 0,
                                   dev)
    before = bd.align_scores_banded.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, band=32768)
    assert bd.align_scores_banded.launches == before


def _parent_rows_equal(got, want, ql, tl, W, n, m):
    """Every parent byte of every row up to each read's last diagonal (the
    rows the kernel writes): the cells outside the matrix too."""
    _, _, m_eff, n_steps = bd.band_shapes(n, m, W)
    last = (ql.long() + tl.long().clamp(max=m_eff)).clamp(max=n_steps + 1)
    for b, d in enumerate(last.tolist()):
        if d >= 2:
            rows = (d - 2) // 4 + 1
            assert torch.equal(got[:rows, b], want[:rows, b]), b


def _strip_case(q, ql, t, tl, band, mode, dash_free, scoring, launches=None):
    """K2 and K4 on the strip path, as the card plans it, against the plain
    version: scores, goals, parents on the cells they are defined on and
    every byte of the rows the kernel writes; one strip call each, no
    other path; ``launches`` cooperative launches a call."""
    plan = bd.band_plan(band, q.shape[0], True, bd.strip_card(q.device))
    assert plan.path == "strip"
    if launches is not None:
        assert -(-q.shape[0] // plan.reads_per_launch) == launches
    m_eff = bd.band_shapes(q.shape[1], t.shape[1], band)[2]
    args = (q, ql, t, tl, *scoring)
    kw = dict(band=band, mode=mode, dash_free=dash_free)
    before = dict(bd.align_scores_banded.path_launches)
    _same(bd.align_scores_banded(*args, **kw),
          bd.align_scores_banded_plain(*args, **kw))
    got = bd.align_scores_banded(*args, **kw, want_parents=True)
    want = bd.align_scores_banded_plain(*args, **kw, want_parents=True)
    after = bd.align_scores_banded.path_launches
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(bd.PATHS, 0), strip=2)
    for f in ("score", "goal_i", "goal_j"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(bd.parent_cells(got.parents, ql, tl, m_eff),
                       bd.parent_cells(want.parents, ql, tl, m_eff))
    _parent_rows_equal(got.parents, want.parents, ql, tl, band, q.shape[1],
                       t.shape[1])
    return got


# Strip widths on an H100 SXM (ops/band.strip_plan): 6 reads take strips
# of 2,048 lanes at W = 32,896 (17 strips, the last of 128) and of 1,024
# at 49,152 and 65,536 (48 and 64, 3 CTAs a SM); the main diagonal
# (W / 2) is a strip edge at 49,152 and 65,536.
STRIP_BANDS = [32896, 49152, 65536]


@pytest.mark.parametrize("band", STRIP_BANDS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_strip_kernels_match_plain(dev, mode, band):
    """Paths that wander ~75-125 lanes over the main diagonal, n <= 1,024,
    both variants, K2 and K4."""
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(band + mode), 6,
                                   1000, 1400, 0, dev)
    for dash_free in (False, True):
        _strip_case(q, ql, t, tl, band, mode, dash_free, (1, -1, -1), 1)


def test_band_strip_kernels_in_several_read_groups(dev):
    """B = 30 at W = 32,896: more strips than the card holds at once, so
    several cooperative launches, their reads spread evenly."""
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(41), 30, 700, 1000,
                                   200, dev)
    plan = bd.band_plan(32896, 30, False, bd.strip_card(dev))
    launches = -(-30 // plan.reads_per_launch)
    assert launches > 1 and 30 % plan.reads_per_launch == 0
    for mode in (0, 1, 2):
        _strip_case(q, ql, t, tl, 32896, mode, True, (1, -1, -1), launches)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_strip_kernels_one_read(dev, mode):
    """B = 1, the -c chunk of a 100 kb read: 64 strips of 1,024 lanes, a
    lead of 2,100 bases puts the path across the edge at lane 33,792."""
    assert bd.band_plan(65536, 1, True, bd.strip_card(dev)).strip == 1024
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(60 + mode), 1,
                                   1000, 3500, 2100, dev)
    for dash_free in (False, True):
        _strip_case(q, ql, t, tl, 65536, mode, dash_free, (1, -1, -1), 1)


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("scoring", [(1, -1, 0), (1, -1, 1)])
def test_band_strip_kernels_on_tie_heavy_pairs(dev, scoring, B):
    """Local goal ties and semiGlobal rim ties on the main diagonal, which
    at W = 65,536 is a strip edge (strips of 1,024 lanes at B = 1, of
    4,096 in five launches at B = 37): the strips' trackers and the last
    CTA's merge must pick what the per-diagonal rules pick."""
    rng = np.random.default_rng(300 + B)
    for dash in (False, True):
        q, ql, t, tl = _tie_pairs(rng, B, 500, 800, dash, dev)
        for mode in (0, 1, 2):
            _strip_case(q, ql, t, tl, 65536, mode, not dash, scoring,
                        1 if B == 1 else 5)


def test_band_strip_refused_launch_raises(dev, monkeypatch):
    """A launch the card cannot hold at once (40 reads of 16 strips in one
    cooperative launch) raises in the wrapper; nothing falls back."""
    plan = bd.band_plan(65536, 40, False, bd.strip_card(dev))
    monkeypatch.setattr(bd, "band_plan",
                        lambda W, B, p, card=None: dataclasses.replace(
                            plan, reads_per_launch=40))
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(2), 40, 600, 800, 0,
                                   dev)
    before = dict(bd.align_scores_banded.path_launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, band=65536)
    assert bd.align_scores_banded.path_launches == before
    # The refusal is not left behind for the next launch to report.
    monkeypatch.undo()
    _same(bd.align_scores_banded(q[:2], ql[:2], t[:2], tl[:2], 1, -1, -1,
                                 band=65536),
          bd.align_scores_banded_plain(q[:2], ql[:2], t[:2], tl[:2], 1, -1,
                                       -1, band=65536))


def test_band_strip_occupancy_meets_the_plan(dev):
    """ops/band.strip_card reads the card: its SM count, at each strip
    width the least occupancy of every strip kernel (K2 and K4, every
    mode, both variants; at least one CTA a SM) and the library's record
    size, which ops/band's constant must match.  Every plan the card makes
    fits it: a launch's CTAs at most what the card holds at once."""
    import ctypes
    from bioinfo1_tpu_torch.kernels import build
    lib = build.library()
    card = bd.strip_card(dev)
    assert bd.strip_card(dev) is card                    # asked once
    props = torch.cuda.get_device_properties(dev)
    assert card.sms == props.multi_processor_count
    assert card.rec_ints == bd.STRIP_REC_INTS
    for S, per_sm in zip(bd.STRIP_WIDTHS, card.per_sm):
        threads = (S + 2 * bd.STRIP_HALO) // 8
        held = []
        for parents in (0, 1):
            for mode in (0, 1, 2):
                for dash_free in (0, 1):
                    n = ctypes.c_int(0)
                    assert lib.bioinfo1_band_strip_occupancy(
                        parents, mode, dash_free, threads,
                        ctypes.byref(n)) == 0
                    held.append(n.value)
        assert per_sm == min(held) >= 1, S
    for W in (32896, 49152, 65536, 200064, card.w_strip):
        for B in (1, 2, 8, 37):
            plan = bd.band_plan(W, B, False, card)
            assert plan.path == "strip"
            assert plan.reads_per_launch * plan.strips <= card.held(
                plan.strip), (W, B)
    assert bd.band_plan(card.w_strip + 128, 1, False, card).path == \
        "epochs"
    assert bd.band_plan(card.w_strip + 128, 1, True, card).path == \
        "scratch"


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_scratch_kernel_matches_plain(dev, monkeypatch, mode):
    """The scratch kernel, which band_plan keeps for bands past W_STRIP:
    at W = 32,896 through ops/band.scratch_plan (as the smoke's control
    runs it), K2 and K4, both variants."""
    monkeypatch.setattr(bd, "band_plan",
                        lambda W, B, p, card=None: bd.scratch_plan(W, p))
    q, ql, t, tl = _pairs(np.random.default_rng(70 + mode), 12, 600, 900,
                          dev)
    m_eff = bd.band_shapes(600, 900, 32896)[2]
    for dash_free in (False, True):
        kw = dict(band=32896, mode=mode, dash_free=dash_free)
        args = (q, ql, t, tl, 1, -1, -1)
        _same(bd.align_scores_banded(*args, **kw),
              bd.align_scores_banded_plain(*args, **kw))
        got = bd.align_scores_banded(*args, **kw, want_parents=True)
        want = bd.align_scores_banded_plain(*args, **kw, want_parents=True)
        for f in ("score", "goal_i", "goal_j"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(bd.parent_cells(got.parents, ql, tl, m_eff),
                           bd.parent_cells(want.parents, ql, tl, m_eff))


def test_band_scratch_path_past_the_strips(dev):
    """W = the card's widest strip band + 128 (540,800 lanes on an H100
    SXM): too wide for one read's strips to be resident at once, so
    band_plan gives K4 the scratch kernel and K2 the "epochs" path; one
    read, each against the plain version."""
    W = bd.strip_card(dev).w_strip + 128
    assert bd.band_plan(W, 1, True, bd.strip_card(dev)).path == "scratch"
    assert bd.band_plan(W, 1, False, bd.strip_card(dev)).path == "epochs"
    q, ql, t, tl = _pairs(np.random.default_rng(80), 1, 300, 400, dev)
    q, ql, t, tl = (x[:1].contiguous() for x in (q, ql, t, tl))
    ql[0], tl[0] = 300, 400
    before = dict(bd.align_scores_banded.path_launches)
    _same(bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, band=W, mode=2),
          bd.align_scores_banded_plain(q, ql, t, tl, 1, -1, -1, band=W,
                                       mode=2))
    got = bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, band=W, mode=0,
                                 want_parents=True)
    want = bd.align_scores_banded_plain(q, ql, t, tl, 1, -1, -1, band=W,
                                        mode=0, want_parents=True)
    after = bd.align_scores_banded.path_launches
    assert after["scratch"] == before["scratch"] + 1
    assert after["epochs"] == before["epochs"] + 1
    for f in ("score", "goal_i", "goal_j"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    _parent_rows_equal(got.parents, want.parents, ql, tl, W, 300, 400)


def _epoch_case(q, ql, t, tl, band, mode, dash_free, scoring):
    """K2 on the "epochs" path as band_plan gives it, against the plain
    version; one "epochs" call, no other path."""
    plan = bd.band_plan(band, q.shape[0], False, bd.strip_card(q.device))
    assert plan.path == "epochs"
    args = (q, ql, t, tl, *scoring)
    kw = dict(band=band, mode=mode, dash_free=dash_free)
    before = dict(bd.align_scores_banded.path_launches)
    got = bd.align_scores_banded(*args, **kw)
    after = bd.align_scores_banded.path_launches
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(bd.PATHS, 0), epochs=1)
    _same(got, bd.align_scores_banded_plain(*args, **kw))
    return got


# A card of 16 SMs (ops/band.StripCard(16, (2, 1, 1))): its strips end at
# w_strip = 65,536 lanes, so K2 at 65,664 takes the "epochs" path: 33
# strips of 2,048, the last of 128; the main diagonal (lane 32,832) on no
# strip edge.
SMALL_CARD = bd.StripCard(16, (2, 1, 1))


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("scoring", [(1, -1, 0), (1, -1, 1), (1, -1, -1)])
def test_band_epoch_kernel_on_tie_heavy_pairs(dev, monkeypatch, scoring, B):
    """Local goal ties and semiGlobal rim ties on tie-heavy pairs (empty
    queries and targets, 1-tall and 1-wide matrices, reads that end in
    every epoch of 128 diagonals), every mode, with dash_free on and off,
    at a W forced past a small card's w_strip: each strip's trackers,
    saved and loaded at every epoch, and the merge must pick what the
    per-diagonal rules pick."""
    monkeypatch.setattr(bd, "strip_card", lambda dev: SMALL_CARD)
    W = SMALL_CARD.w_strip + 128
    rng = np.random.default_rng(500 + B)
    for dash in (False, True):
        q, ql, t, tl = _tie_pairs(rng, B, 500, 800, dash, dev)
        for mode in (0, 1, 2):
            for dash_free in ((False,) if dash else (False, True)):
                _epoch_case(q, ql, t, tl, W, mode, dash_free, scoring)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_epoch_kernel_against_scratch_past_w_strip(dev, monkeypatch,
                                                         mode):
    """W = 540,800, the first multiple of 128 past an H100 SXM's w_strip:
    K2 on the "epochs" path (264 strips of 2,048 and one of 128) against
    the scratch kernel it replaces there and the plain version, on pairs
    whose paths wander over the main diagonal, both variants."""
    W = 540800
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(90 + mode), 3,
                                   900, 1300, 0, dev)
    for dash_free in (False, True):
        kw = dict(band=W, mode=mode, dash_free=dash_free)
        with monkeypatch.context() as m:
            m.setattr(bd, "strip_card", lambda dev: bd.H100_SXM)
            got = _epoch_case(q, ql, t, tl, W, mode, dash_free, (1, -1, -1))
        with monkeypatch.context() as m:
            m.setattr(bd, "band_plan",
                      lambda W, B, p, card=None: bd.scratch_plan(W, p))
            _same(got, bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, **kw))


@pytest.mark.parametrize("width", [128, 1024])
def test_band_epoch_kernel_narrow_strips(dev, monkeypatch, width):
    """The "epochs" kernel at strip widths a caller may name (the trial's):
    strips of 128 lanes, as narrow as a strip gets, and of 1,024, at W =
    4,224 and 8,320 (a ragged last strip), every mode."""
    monkeypatch.setattr(bd, "band_plan",
                        lambda W, B, p, card=None: bd.epoch_plan(W, width))
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(width), 5, 700,
                                   1000, 0, dev)
    for W in (4224, 8320):
        for mode in (0, 1, 2):
            _epoch_case(q, ql, t, tl, W, mode, True, (1, -1, -1))


def test_band_epoch_refused_plan_raises(dev, monkeypatch):
    """A plan the library was not built for (a halo of 32 lanes, strips of
    8,192 lanes, or K4 on the "epochs" path) raises in the wrapper; nothing
    falls back and no launch is counted."""
    q, ql, t, tl = _crossing_pairs(np.random.default_rng(3), 2, 700, 1000,
                                   0, dev)
    for plan, parents in ((bd.epoch_plan(4224, 1024, halo=32), False),
                          (dataclasses.replace(bd.epoch_plan(8320),
                                               strip=8192), False),
                          (bd.epoch_plan(4224), True)):
        monkeypatch.setattr(bd, "band_plan",
                            lambda W, B, p, card=None, plan=plan: plan)
        before = dict(bd.align_scores_banded.path_launches)
        with pytest.raises(RuntimeError, match="CUDA error"):
            bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, band=4224,
                                   want_parents=parents)
        assert bd.align_scores_banded.path_launches == before


def test_band_kernel_ragged_last_cta(dev):
    """More one-warp reads than fill whole CTAs: the last CTA's spare
    warps leave, every read is served."""
    B = 2 * bd.SM_COUNT * 2 + 3
    assert bd.band_plan(128, B, False).reads_per_cta == 2
    q, ql, t, tl = _tie_pairs(np.random.default_rng(9), B, 200, 300, True,
                              dev)
    for mode in (0, 1, 2):
        _same(bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, band=128,
                                     mode=mode),
              bd.align_scores_banded_plain(q, ql, t, tl, 1, -1, -1,
                                           band=128, mode=mode))


@pytest.mark.parametrize("scoring", [(1, -1, 1), (1, -1, 0)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_parents_whole_matrix_matches_plain(dev, mode, scoring):
    """The staged path's -c shape: a band that covers the whole matrix,
    under scorings with no exactness certificate (many ties)."""
    q, ql, t, tl = _pairs(np.random.default_rng(20 + mode), 12, 600, 900,
                          dev)
    W = -(-max(int(ql.max()), int(tl.max()) + 2) // 128) * 128
    m_eff = bd.band_shapes(600, 900, W)[2]
    args = (q, ql, t, tl, *scoring)
    got = bd.align_scores_banded(*args, band=W, mode=mode,
                                 want_parents=True)
    want = bd.align_scores_banded_plain(*args, band=W, mode=mode,
                                        want_parents=True)
    for f in ("score", "goal_i", "goal_j"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(bd.parent_cells(got.parents, ql, tl, m_eff),
                       bd.parent_cells(want.parents, ql, tl, m_eff))
    assert bool(bd.certify(got.score, *args, W, strict=True,
                           mode=mode).all())
    walk_args = (got.parents, got.goal_i, got.goal_j, got.score, q, t,
                 *scoring, mode)
    assert torch.equal(tr.walk_parents(*walk_args),
                       tr.walk_parents_plain(*walk_args))
    # The full-matrix score kernel sees the same DP.
    full = al.align_scores(q, ql, t, tl, mode, *scoring)
    for f in ("score", "goal_i", "goal_j"):
        assert torch.equal(getattr(got, f), getattr(full, f)), f


def _walk_case(par, gi, gj, score, q, t, scoring, mode):
    """K5 against the plain walk, exactly, on one launch."""
    args = (par, gi, gj, score, q, t, *scoring, mode)
    before = tr.walk_parents.launches
    got = tr.walk_parents(*args)
    assert tr.walk_parents.launches == before + 1
    assert torch.equal(got, tr.walk_parents_plain(*args)), mode
    return got


# The register paths (128, 256, 4,096), the cluster path (19,968: 6 CTAs
# of 416 threads) and the strip path (32,896).
WALK_BANDS = [128, 256, 4096, 19968, 32896]


@pytest.mark.parametrize("band", WALK_BANDS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_walk_kernel_matches_plain_on_every_band_path(dev, mode, band):
    """K4's parents of every dispatch path; '-' bytes in a quarter of the
    rows (local mode's free gaps) and an empty last row."""
    q, ql, t, tl = _pairs(np.random.default_rng(30 + mode), 12, 600, 900,
                          dev)
    out = bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, band=band,
                                 mode=mode, want_parents=True)
    _walk_case(out.parents, out.goal_i, out.goal_j, out.score, q, t,
               (1, -1, -1), mode)


@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("scoring", [(1, -1, 0), (1, -1, 1), (1, -1, -1)])
def test_walk_kernel_on_tie_heavy_pairs(dev, scoring, B):
    """Two-letter pairs with '-' bytes, empty queries and targets, 1-tall
    and 1-wide matrices, at W = 128 (paths that leave the band: the lane
    clip at 0 and W - 1) and 640; gap >= 0 leaves most reads uncertified.
    B = 33 is no multiple of the warps a block holds."""
    rng = np.random.default_rng(200 + B)
    for band in (128, 640):
        for dash in (False, True):
            q, ql, t, tl = _tie_pairs(rng, B, 500, 800, dash, dev)
            for mode in (0, 1, 2):
                out = bd.align_scores_banded(q, ql, t, tl, *scoring,
                                             band=band, mode=mode,
                                             want_parents=True)
                _walk_case(out.parents, out.goal_i, out.goal_j, out.score,
                           q, t, scoring, mode)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_walk_kernel_on_random_parents(dev, mode):
    """Random parent bytes, a third of them 3 (a stuck walk emits 3 and
    stays for all 4 * (S4 + 1) steps), some rows all 3, goals anywhere in
    the matrix (past the last parent row too: the row clip at the goal),
    scores <= 0, (0, 0) goals; B = 531 reads, no multiple of the warps a
    block holds.  Local mode's cost can rise on gaps < 0 and walk below
    row 0, where the lane drifts out of any staged window."""
    rng = np.random.default_rng(300 + mode)
    B, S4, W, qn, tm = 531, 24, 128, 150, 170
    par = rng.integers(0, 256, (S4, B, W)).astype(np.uint8)
    par[rng.random((S4, B, W)) < 0.1] = 0xFF
    par[5:7] = 0xFF
    gi = rng.integers(0, qn + 1, B).astype(np.int32)
    gj = rng.integers(0, tm + 1, B).astype(np.int32)
    gi[:3], gj[:3] = 0, 0
    score = rng.integers(-2, 40, B).astype(np.int32)
    letters = np.frombuffer(b"AC-", np.uint8)
    q = letters[rng.integers(0, 3, (B, qn))]
    t = letters[rng.integers(0, 3, (B, tm))]
    args = [torch.from_numpy(x).to(dev) for x in (par, gi, gj, score, q, t)]
    for scoring in ((1, -1, -1), (1, -1, 1), (2, -3, 0)):
        _walk_case(*args, scoring, mode)


def test_walk_kernel_long_chain(dev):
    """One chain of >= 20,000 steps (two 22 kb reads at W = 512): some
    350 slabs of one read, each staged while the one before is walked."""
    rng = np.random.default_rng(50)
    qa = np.zeros((2, 24000), np.uint8)
    ta = np.zeros((2, 25000), np.uint8)
    ql = np.zeros(2, np.int32)
    for b in range(2):
        tgt = simulate.random_genome(22000, rng)
        qry = simulate.mutate_read(tgt, rng)[:24000]
        qa[b, :len(qry)], ql[b], ta[b, :22000] = qry, len(qry), tgt
    q, ql, t = (torch.from_numpy(x).to(dev) for x in (qa, ql, ta))
    tl = torch.full((2,), 22000, dtype=torch.int32, device=dev)
    for mode in (0, 1):
        out = bd.align_scores_banded(q, ql, t, tl, 1, -1, -1, band=512,
                                     mode=mode, want_parents=True)
        codes = _walk_case(out.parents, out.goal_i, out.goal_j, out.score,
                           q, t, (1, -1, -1), mode)
        steps = (tr.unpack_codes(codes.cpu().numpy()) != tr.OP_DONE).sum(0)
        assert steps.max() >= 20000


def test_walk_kernel_rejects_unaligned_parent_rows(dev):
    """Slabs are copied in 16-byte chunks: parent rows off a 16-byte
    boundary raise, launching nothing."""
    n = torch.ones(2, dtype=torch.int32, device=dev)
    qt = torch.zeros((2, 8), dtype=torch.uint8, device=dev)
    base = torch.zeros(4 * 2 * 128 + 1, dtype=torch.uint8, device=dev)
    before = tr.walk_parents.launches
    for par in (base[1:].view(4, 2, 128),
                torch.zeros((4, 2, 136), dtype=torch.uint8, device=dev)):
        assert par.is_contiguous()
        with pytest.raises(ValueError, match="16-byte"):
            tr.walk_parents(par, n, n, n, qt, qt, 1, -1, -1, 0)
    assert tr.walk_parents.launches == before


@pytest.mark.parametrize("shape,n_iter", [((256, 1024), 100), ((8, 128), 0),
                                          ((3, 5, 7), 7), ((1000,), 33)])
def test_int32_probe_kernel_matches_plain(dev, shape, n_iter):
    rng = np.random.default_rng(n_iter)
    x = torch.from_numpy(rng.integers(-10**6, 10**6, shape)
                         .astype(np.int32)).to(dev)
    x.view(-1)[:3] = torch.tensor([2**31 - 1, -2**31, 2**31 - 50],
                                  dtype=torch.int32)     # wrap-around
    before = probe.int32_probe.launches
    got = probe.int32_probe(x, n_iter)
    assert probe.int32_probe.launches == before + 1
    assert torch.equal(got, probe.int32_probe_plain(x, n_iter))
    with pytest.raises(ValueError):
        probe.int32_probe(x.view(-1)[::2], 1)           # not contiguous


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("scoring", [(1, -1, -1), (2, -3, 1), (1, -1, 0)])
def test_full_kernel_matches_plain(dev, mode, scoring):
    q, ql, t, tl = _pairs(np.random.default_rng(7), 16, 300, 500, dev)
    _same(al.align_scores(q, ql, t, tl, mode, *scoring),
          al.align_scores_plain(q, ql, t, tl, mode, *scoring))


def _strip_pairs(rng, B, n, m, S, dev):
    """Pairs for K3's strips: tie-heavy two-letter rows with '-' bytes at
    the thread and strip edges (rows LPT, S and S + 1), the edge rows
    (q_len + t_len in {0, 1, 2}, q_len = 0, t_len = 0), a one-row last
    strip (q_len = S + 1) and rows just past every multiple of S."""
    q, ql, t, tl = (x.cpu().numpy() for x in _tie_pairs(rng, B, n, m, True,
                                                         "cpu"))
    edge = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (n, 0), (0, m),
            (min(n, S + 1), m), (n, m)]
    edge += [(min(n, k * S + 1), m - k) for k in range(1, 4)]
    for b, (x, y) in enumerate(edge[:B - 2]):
        ql[b + 2], tl[b + 2] = x, y
    lpt = S // 32
    for r in (lpt - 1, lpt, S - 1, S, S + 1):
        if r < n:
            q[1::2, r] = ord("-")
    t[::3, min(S, m - 1)] = ord("-")
    return [torch.from_numpy(x).to(dev) for x in (q, ql, t, tl)]


@pytest.mark.parametrize("width", ["S-1", "S", "S+1", "3S+5"])
@pytest.mark.parametrize("lpt", al.FULL_LPTS)
def test_full_kernel_every_strip_count(dev, monkeypatch, lpt, width):
    """K3 on one strip, exactly one, one row past it and four strips, at
    every rows-per-thread choice, every mode, scorings with gap < 0, gap
    > 0 (positive borders) and gap 0, against the plain version; one
    launch a call."""
    monkeypatch.setattr(al, "FULL_LPT", lpt)
    S = 32 * lpt
    n = {"S-1": S - 1, "S": S, "S+1": S + 1, "3S+5": 3 * S + 5}[width]
    q, ql, t, tl = _strip_pairs(np.random.default_rng(n), 17, n, n + 40, S,
                                dev)
    assert al.full_plan(n, 17).strips == -(-n // S)
    for mode in (0, 1, 2):
        for scoring in ((1, -1, -1), (2, -3, 1), (1, -1, 0)):
            before = al.align_scores.launches
            got = al.align_scores(q, ql, t, tl, mode, *scoring)
            assert al.align_scores.launches == before + 1
            _same(got, al.align_scores_plain(q, ql, t, tl, mode, *scoring))


@pytest.mark.parametrize("B,sm_count", [(7, 1), (531, al.SM_COUNT)])
def test_full_kernel_ragged_last_cta(dev, monkeypatch, B, sm_count):
    """More reads than fill whole CTAs: the last CTA's spare warps leave
    at once, every read is served (7 reads at 3 a CTA with the SM count
    set to 1; 531 at 2 a CTA on the H100's)."""
    monkeypatch.setattr(al, "SM_COUNT", sm_count)
    plan = al.full_plan(600, B)
    assert plan.warps_per_cta > 1 and B % plan.warps_per_cta
    q, ql, t, tl = _strip_pairs(np.random.default_rng(B), B, 600, 640,
                                32 * plan.lpt, dev)
    for mode in (0, 1, 2):
        _same(al.align_scores(q, ql, t, tl, mode, 1, -1, -1),
              al.align_scores_plain(q, ql, t, tl, mode, 1, -1, -1))


def test_full_kernel_refused_launch_raises(dev, monkeypatch):
    """A launch the C entry point refuses (here: rows per thread it was
    not built for) raises and counts nothing; nothing falls back."""
    q, ql, t, tl = _pairs(np.random.default_rng(3), 4, 64, 80, dev)
    monkeypatch.setattr(al, "FULL_LPTS", (8, 16, 32, 64))
    monkeypatch.setattr(al, "FULL_LPT", 64)
    before = al.align_scores.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        al.align_scores(q, ql, t, tl, 0, 1, -1, -1)
    assert al.align_scores.launches == before


def test_wrappers_reject_bad_input(dev):
    f = torch.zeros((2, 8), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        ch.lis_chain(f, f, torch.zeros(2, dtype=torch.int32, device=dev))
    q = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    n = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        bd.align_scores_banded(q, n, q, n, 1, -1, -1)
    par = torch.zeros((4, 2, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        tr.walk_parents(par, n, n, n, q, q, 1, -1, -1, 0)


def _map_problem():
    rng = np.random.default_rng(11)
    genome = simulate.random_genome(60000, rng)
    index = builder.build_index(genome.tobytes().decode("latin1"), 13, 5,
                                0.001)
    recs = simulate.simulate_reads(genome, rng.integers(300, 2000, 24), rng)
    L = 2048
    arr = np.zeros((len(recs), L), np.uint8)
    lens = np.zeros(len(recs), np.int32)
    for i, (_, s) in enumerate(recs):
        arr[i, :len(s)] = np.frombuffer(s.encode("latin1"), np.uint8)
        lens[i] = len(s)
    return index, arr, lens


@pytest.mark.parametrize("band", [0, 256])
def test_map_step_cuda_matches_cpu(dev, band):
    index, arr, lens = _map_problem()
    outs = []
    for d in (dev, torch.device("cpu")):
        didx = dm.device_index_from_host(index, d)
        outs.append(dm.map_step(
            torch.from_numpy(arr).to(d), torch.from_numpy(lens).to(d), didx,
            1, -1, -1, k=13, w=5, mode=0, budget=1024, region_cap=4096,
            band=band).to_numpy())
    assert outs[0].mapped.sum() > 12
    for f in outs[0].__dataclass_fields__:
        np.testing.assert_array_equal(getattr(outs[0], f),
                                      getattr(outs[1], f), err_msg=f)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_map_step_cigar_cuda_matches_cpu(dev, mode):
    index, arr, lens = _map_problem()
    outs = []
    for d in (dev, torch.device("cpu")):
        didx = dm.device_index_from_host(index, d)
        outs.append(dm.map_step_cigar(
            torch.from_numpy(arr).to(d), torch.from_numpy(lens).to(d), didx,
            1, -1, -1, k=13, w=5, mode=mode, budget=1024, region_cap=4096,
            band=256).to_numpy())
    got, want = outs
    assert got.base.mapped.sum() > 12
    for f in got.base.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got.base, f),
                                      getattr(want.base, f), err_msg=f)
    for f in ("goal_i", "goal_j", "q_len", "t_len", "certified"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    ok = got.base.mapped & got.certified
    assert ok.sum() > 8
    np.testing.assert_array_equal(got.codes[:, ok], want.codes[:, ok])


@pytest.mark.parametrize("cigar", [False, True], ids=["score", "c"])
def test_dealt_batches_on_two_streams_match_one(dev, monkeypatch, cigar):
    """Batches dealt to two streams of one card (parallel/shard.py), one
    index copy: each batch launches its kernels from its worker thread on
    its entry's stream, and the PAF and every counter but the timings
    equal the one-entry mapper's, batch by batch."""
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")
    rng = np.random.default_rng(12)
    genome = simulate.random_genome(60000, rng)
    refs = [("g", genome.tobytes().decode("latin1"))]
    seqs = [s for _, s in simulate.simulate_reads(
        genome, rng.integers(300, 3000, 48), rng)]
    cfg = MapperConfig(output_cigar=cigar)
    runs = []
    for devices in ([dev, dev], [dev]):
        mapper = Mapper(refs, cfg, devices=devices)
        build.launches_by_device.clear()
        results = [mapper.map_batch(seqs[o:o + 16])
                   for o in range(0, len(seqs), 16)]
        assert build.launches_by_device.get(dev.index, 0) >= 3
        runs.append((results, {k: v for k, v in
                               mapper.counters.as_dict().items()
                               if not k.startswith("t_")},
                     mapper.devices.batches))
    (got, got_counts, dealt), (want, want_counts, _) = runs
    assert dealt == [2, 1]
    assert got == want and got_counts == want_counts
    assert got_counts["faults"] == 0 and got_counts["mapped"] >= 40
    # In flight at once: the same lines as the one-entry run.
    mapper = Mapper(refs, MapperConfig(output_cigar=cigar, batch_size=8),
                    devices=[dev, dev])
    recs = [(f"r{i}", s) for i, s in enumerate(seqs)]
    lines = mapper.map_records(recs)
    assert lines == Mapper(refs, cfg, devices=[dev]).map_records(recs)
    assert min(mapper.devices.batches) >= 2
    assert mapper.counters.faults == 0


@pytest.mark.parametrize("cigar", [False, True], ids=["score", "c"])
def test_batch_records_count_the_kernels_the_trace_ties_to_them(
        dev, monkeypatch, tmp_path, cigar):
    """Each ``map_batch`` call's record (utils/tracing) counts its kernel
    launches by (entry point, path); a trace of the run ties the same port
    kernels, by the launch's correlation id and thread, to the call's
    ``batch#<id>`` scope."""
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    from bioinfo1_tpu_torch.utils import tracing
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")
    rng = np.random.default_rng(21)
    genome = simulate.random_genome(60000, rng)
    recs = simulate.simulate_reads(genome, rng.integers(200, 3000, 96), rng)
    mapper = Mapper([("g", genome.tobytes().decode("latin1"))],
                    MapperConfig(batch_size=16, output_cigar=cigar),
                    device=dev)
    # Warm first, as the benchmark does before its stretch: in a second
    # profiler session of one process the profiler has left a first
    # batch's kernels untied to their launches (PERF.md, section 6).
    mapper.map_records(recs)
    with tracing.device_trace(str(tmp_path), dev):
        lines = mapper.map_records(recs)
    assert len(lines) >= len(recs) - 4 and mapper.counters.faults == 0
    traced = tracing.batch_kernels(str(tmp_path / tracing.TRACE_FILE))
    mine = [r for r in tracing.batches if r.id in traced]
    assert len(mine) == len(traced) >= 4
    assert len({r.thread for r in mine}) > 1
    for r in mine:
        assert traced[r.id] == r.launches, (r.id, traced[r.id], r.launches)
        assert r.device == dev.index and r.t1_ns > r.t0_ns
    entries = {e for r in mine for e, _path in r.launches}
    assert {"bioinfo1_lis_chain", "bioinfo1_band_score"} <= entries
    if cigar:
        assert {"bioinfo1_band_parents", "bioinfo1_walk_parents"} <= entries


def _lookup_queries(dev):
    """The compacted minimizer queries of ``_map_problem``'s batch on
    ``dev`` and its index."""
    from bioinfo1_tpu_torch.ops import match as mo
    from bioinfo1_tpu_torch.ops import minimizer as mz
    index, arr, lens = _map_problem()
    mres = mz.minimize_batch(torch.from_numpy(arr).to(dev),
                             torch.from_numpy(lens).to(dev), 13, 5)
    return index, mo.compact_queries(mres.hashes, mres.pos,
                                     mres.dedup_keep, 1024)[:3]


@pytest.mark.parametrize("budget", [64, 1024])
def test_sharded_lookup_on_one_card_matches_replicated(dev, budget):
    """Two shards of one card (parallel/shard.shard_index over [cuda:0,
    cuda:0]), the lookup from a batch stream while the card's default
    stream is busy: every Matches field equals the replicated lookup's,
    and the lookup finished without waiting for the default stream (its
    shards run on the card's lookup stream)."""
    from bioinfo1_tpu_torch.ops import match as mo
    from bioinfo1_tpu_torch.parallel import shard as ps
    index, (q_hash, q_pos, q_keep) = _lookup_queries(dev)
    rep = dm.device_index_from_host(index, dev)
    want = mo.find_matches_combined(
        q_hash, q_pos, q_keep, rep.key_hash, rep.key_pos, rep.cnt_fr,
        rep.cnt_r2, rep.bucket_off, rep.shift, rep.bsearch_steps, budget,
        rep.cnt_shift)
    shd = ps.shard_index(index, ps.DeviceSet([dev, dev]))[dev]
    assert len(set(id(s) for s in shd.streams)) == 1

    def lookup():
        return mo.find_matches_combined_sharded(
            q_hash, q_pos, q_keep, shd.shards, shd.shards[0].shard_range,
            budget, shd.shards[0].cnt_shift, streams=shd.streams,
            served=shd.served)

    batch = torch.cuda.Stream(dev)
    with torch.cuda.stream(batch):
        lookup()                                # warm up
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(int(3e9))                 # ~1.5 s on the default stream
    with torch.cuda.stream(batch):
        got = lookup()
        done = batch.record_event()
    done.synchronize()
    busy = not torch.cuda.default_stream(dev).query()
    torch.cuda.synchronize(dev)
    assert busy, "the lookup waited for the default stream"
    for g, w_ in zip(got, want):
        _same(g, w_)
    assert all(int(s) > 0 for s in shd.served)
    if budget == 64:
        assert bool(want[0].overflow.any() or want[1].overflow.any())


@pytest.mark.parametrize("cigar", [False, True], ids=["score", "c"])
def test_sharded_index_on_two_streams_matches_replicated(dev, monkeypatch,
                                                         cigar):
    """BIOINFO1_INDEX_SHARD=1 on [cuda:0, cuda:0]: two shards, two batch
    streams and the card's lookup stream; batch by batch the results and
    every counter but the timings equal the replicated two-entry mapper's,
    and with batches in flight the lines are the same."""
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")
    rng = np.random.default_rng(13)
    genome = simulate.random_genome(60000, rng)
    refs = [("g", genome.tobytes().decode("latin1"))]
    seqs = [s for _, s in simulate.simulate_reads(
        genome, rng.integers(300, 3000, 48), rng)]
    recs = [(f"r{i}", s) for i, s in enumerate(seqs)]
    cfg = MapperConfig(output_cigar=cigar)
    runs = []
    for shard in ("1", "0"):
        monkeypatch.setenv("BIOINFO1_INDEX_SHARD", shard)
        mapper = Mapper(refs, cfg, devices=[dev, dev])
        assert isinstance(mapper.device_index(),
                          dm.ShardedIndex) == (shard == "1")
        results = [mapper.map_batch(seqs[o:o + 16])
                   for o in range(0, len(seqs), 16)]
        lines = Mapper(refs, MapperConfig(output_cigar=cigar, batch_size=8),
                       devices=[dev, dev]).map_records(recs)
        runs.append((results, {k: v for k, v in
                               mapper.counters.as_dict().items()
                               if not k.startswith("t_")}, lines,
                     mapper.device_index()))
    (got, got_counts, got_lines, shd), (want, want_counts, want_lines,
                                        _) = runs
    assert got == want and got_counts == want_counts
    assert got_lines == want_lines and len(got_lines) >= 40
    assert got_counts["faults"] == 0
    assert all(int(s) > 0 for s in shd.served)


@pytest.mark.parametrize("flags", [[], ["-c"], ["-c", "-a", "local"],
                                   ["-c", "-a", "semiGlobal"],
                                   ["-c", "-g", "1"],
                                   ["-c", "-a", "semiGlobal", "-g", "1"],
                                   ["-g", "1"], ["-a", "local", "-g", "1"]])
def test_cli_cuda_matches_cpu(dev, tmp_path, monkeypatch, flags):
    from bioinfo1_tpu_torch import cli
    rng = np.random.default_rng(3)
    genome = simulate.random_genome(50000, rng)
    (tmp_path / "ref.fa").write_text(
        ">g\n" + genome.tobytes().decode("latin1") + "\n")
    recs = simulate.simulate_reads(genome, [300, 900, 2500, 4000] * 4, rng)
    with open(tmp_path / "r.fq", "w") as fh:
        for name, s in recs:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")
    outs = []
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("BIOINFO1_PLATFORM", platform)
        out = io.StringIO()
        assert cli.main(flags + [str(tmp_path / "ref.fa"),
                                 str(tmp_path / "r.fq")], stdout=out) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") >= 12
    assert outs[0].count("cg:Z:") == (outs[0].count("\n") if "-c" in flags
                                      else 0)


def test_cli_bug_compat_fasta_cuda_matches_cpu(dev, tmp_path, monkeypatch):
    """FASTA match nesting: the whole run on the staged host path."""
    from bioinfo1_tpu_torch import cli
    rng = np.random.default_rng(4)
    genome = simulate.random_genome(50000, rng)
    (tmp_path / "ref.fa").write_text(
        ">g\n" + genome.tobytes().decode("latin1") + "\n")
    recs = simulate.simulate_reads(genome, [300, 900, 2500] * 6, rng)
    with open(tmp_path / "r.fa", "w") as fh:
        for name, s in recs:
            fh.write(f">{name}\n{s}\n")
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")
    for flags in (["--bug-compat"], ["--bug-compat", "-c", "-a", "local"]):
        outs = []
        for platform in ("cuda", "cpu"):
            monkeypatch.setenv("BIOINFO1_PLATFORM", platform)
            out = io.StringIO()
            assert cli.main(flags + [str(tmp_path / "ref.fa"),
                                     str(tmp_path / "r.fa")],
                            stdout=out) == 0
            outs.append(out.getvalue())
        assert outs[0] == outs[1]
        assert outs[0].count("\n") >= 5
