"""K3's strip sweep (csrc/full_score.cu), replayed on the CPU, and its plan.

K3 runs one warp per read.  A thread keeps ``ops/align.FULL_LPT`` query
rows in registers, so the warp sweeps the rows in strips of S = 32 * LPT:
the strip with top row r0 + 1 runs diagonals r0 + 2 .. min(r0 + S, q_len)
+ t_len, takes row r0 from the strip above through a per-read row buffer
(columns 1..t_len; column 0 is r0 * init, row 0 is computed), writes its
own bottom row there, and keeps the goal trackers in registers: per row
the first strict maximum (local), per row its column-t_len cell and the
q_len row's cells (semiGlobal), folded once per strip and reduced once per
read.  ``_replay`` does the same in numpy with a small S, so every goal
rule crosses several strip boundaries.  It must equal the JAX package's
lax ``align_batch(want_parents=False)`` and the port's plain version.
``full_plan`` is held to its launch shapes, and the wrapper to refusing
bad input before any launch (on ``meta`` tensors, which need no card).
Inputs: random ACGT pairs with '-' bytes at strip edges, a two-letter
alphabet (ties), q_len just past a multiple of S, q_len + t_len in {0, 1,
2}, q_len = 0, t_len = 0; gap < 0, 0 and > 0.  Tolerance: exact.
"""

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.ops import align as jal
from bioinfo1_tpu_torch.ops import align as tal

_NEG = -(2**31) + 2
_DASH = 45


# ---- the strip sweep, replayed --------------------------------------------

def _replay_read(q, ql, t, tl, mode, match, mismatch, gap, S):
    """One read through K3's strips of S rows: (score, goal_i, goal_j)."""
    init = gap if mode == 0 else 0
    if mode == 0 and (ql + tl < 2 or ql == 0 or tl == 0):
        return (0 if ql + tl < 2 else (tl if ql == 0 else ql) * gap,
                ql, tl)
    row = np.full(tl + 1, 123456789, np.int64)  # unwritten: never read
    best = (_NEG, 0, 0)
    col, low = (0, 0), (0, 0)                   # semiGlobal trackers
    score = 0
    strips = -(-ql // S) if tl > 0 else 0
    x = np.arange(S)
    for s in range(strips):
        r0 = s * S
        last = s == strips - 1
        i = r0 + 1 + x
        qb = np.where(i <= ql, q[np.minimum(i, len(q)) - 1], 0)
        up_cost = np.where(qb == _DASH, 0, gap)
        h1 = i * init                             # every column <= 0
        h2 = h1.copy()
        e_dg = r0 * init
        lane_best = np.full(S, _NEG, np.int64)
        lane_best_d = np.zeros(S, np.int64)
        d_lo, d_hi = r0 + 2, min(r0 + S, ql) + tl
        d_end = d_lo + 2 * (-(-(d_hi - d_lo + 1) // 2)) - 1   # whole pairs
        for d in range(d_lo, d_end + 1):
            j = d - i
            j0 = d - r0 - 1
            top = (j0 * init if r0 == 0
                   else (r0 * init if j0 <= 0 else
                         (row[j0] if j0 <= tl else 0)))
            tb = np.where((j >= 1) & (j <= tl), t[np.clip(j, 1, len(t)) - 1],
                          0)
            up = np.concatenate(([top], h1[:-1]))
            dg = np.concatenate(([e_dg], h2[:-1]))
            h = np.maximum(np.maximum(dg + np.where(qb == tb, match,
                                                    mismatch),
                                      h1 + np.where(tb == _DASH, 0, gap)),
                           up + up_cost)
            if mode == 1:
                h = np.maximum(h, 0)
            h = np.where(j <= 0, i * init, h)
            e_dg = top
            h2, h1 = h1, h
            if mode == 1:
                take = (j >= 1) & (j <= tl) & (h > lane_best)
                lane_best = np.where(take, h, lane_best)
                lane_best_d = np.where(take, d, lane_best_d)
            elif mode == 2:
                ic = d - tl
                if r0 + 1 <= ic <= min(r0 + S, ql) and h[ic - r0 - 1] > col[0]:
                    col = (int(h[ic - r0 - 1]), ic)
                if last and 1 <= d - ql <= tl and h[ql - r0 - 1] > low[0]:
                    low = (int(h[ql - r0 - 1]), d - ql)
            if not last and 1 <= d - r0 - S <= tl:
                row[d - r0 - S] = h[S - 1]       # the bottom row, behind
            if mode == 0 and last and d == d_hi:
                score = int(h[ql - r0 - 1])
        if mode == 1:
            for k in range(S):
                cand = (int(lane_best[k]), int(i[k]),
                        int(lane_best_d[k] - i[k]))
                if i[k] <= ql and (cand[0] > best[0] or (
                        cand[0] == best[0] and cand[1:] < best[1:])):
                    best = cand
    if mode == 0:
        return score, ql, tl
    if mode == 1:
        return best if best[0] > _NEG else (0, 0, 0)
    return (low[0], ql, low[1]) if low[0] > col[0] else (col[0], col[1], tl)


def _replay(qa, ql, ta, tl, mode, scoring, S):
    out = np.array([_replay_read(qa[b].astype(np.int64), int(ql[b]),
                                 ta[b].astype(np.int64), int(tl[b]), mode,
                                 *scoring, S) for b in range(len(ql))])
    return out.T


def _pairs(seed, S, alphabet=b"ACGT-", B=12, n=45, m=60):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    qa = letters[rng.integers(0, len(letters), (B, n))].astype(np.uint8)
    ta = letters[rng.integers(0, len(letters), (B, m))].astype(np.uint8)
    ql = rng.integers(0, n + 1, B).astype(np.int32)
    tl = rng.integers(0, m + 1, B).astype(np.int32)
    for b, (x, y) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1), (0, 7),
                                (9, 0), (S + 1, m), (2 * S + 1, m - 5),
                                (S, 3)]):
        ql[b], tl[b] = min(x, n), y
    ta[-1, :n] = qa[-1, :n]                  # a near-copy
    ta[-1, 10] = ord("A") if ta[-1, 10] != ord("A") else ord("C")
    ql[-1], tl[-1] = n, m
    if b"-" in alphabet:                     # '-' at strip edges
        for r in (S - 1, S, S + 1, 2 * S):
            if r < n:
                qa[::2, r] = ord("-")
        ta[1::2, S] = ord("-")
    return qa, ql, ta, tl


@pytest.mark.parametrize("S", [4, 8, 32])
@pytest.mark.parametrize("alphabet", [b"ACGT-", b"AC"], ids=["dash", "two"])
@pytest.mark.parametrize("scoring", [(1, -1, -1), (1, -1, 0), (2, -3, 1)],
                         ids=["gap-1", "gap0", "gap+1"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_strip_replay_matches_jax_and_plain(mode, scoring, alphabet, S):
    qa, ql, ta, tl = _pairs(3 * S + mode, S, alphabet)
    got = _replay(qa, ql, ta, tl, mode, scoring, S)
    lax = jax.device_get(jal.align_batch(qa, ql, ta, tl, mode, *scoring,
                                         want_parents=False))
    plain = tal.align_scores(*(torch.from_numpy(x)
                               for x in (qa, ql, ta, tl)), mode, *scoring)
    for k, f in enumerate(("score", "goal_i", "goal_j")):
        np.testing.assert_array_equal(got[k], getattr(lax, f), err_msg=f)
        np.testing.assert_array_equal(got[k], getattr(plain, f).numpy(),
                                      err_msg=f)


# ---- full_plan ------------------------------------------------------------

# Widths n as functions of the strip rows S.
_WIDTHS = {"1": lambda S: 1, "S-1": lambda S: S - 1, "S": lambda S: S,
           "S+1": lambda S: S + 1, "4608": lambda S: 4608,
           "50000": lambda S: 50000}


@pytest.mark.parametrize("B", [1, 3, 64, 263, 264, 531, 1056, 5000])
@pytest.mark.parametrize("width", list(_WIDTHS))
@pytest.mark.parametrize("lpt", tal.FULL_LPTS)
def test_full_plan_shapes(monkeypatch, lpt, width, B):
    monkeypatch.setattr(tal, "FULL_LPT", lpt)
    S = 32 * lpt
    n = _WIDTHS[width](S)
    plan = tal.full_plan(n, B)
    assert (plan.lpt, plan.strip_rows) == (lpt, S)
    assert plan.strips == -(-n // S) >= 1
    assert plan.needs_row_buffer == (n > S)
    assert 1 <= plan.warps_per_cta <= tal.FULL_MAX_WARPS_PER_CTA
    # Reads spread over the SMs first: one a CTA until they outnumber two
    # per SM.
    assert plan.warps_per_cta == max(1, min(
        tal.FULL_MAX_WARPS_PER_CTA, B // (2 * tal.SM_COUNT)))
    # Every read has a warp; only the last CTA may be ragged.
    assert (plan.grid - 1) * plan.warps_per_cta < B
    assert plan.grid * plan.warps_per_cta >= B


def test_full_plan_ragged_last_cta():
    plan = tal.full_plan(512, 531)
    assert plan.warps_per_cta == 2 and plan.grid == 266
    assert 531 - (plan.grid - 1) * plan.warps_per_cta == 1


@pytest.mark.parametrize("n,B,lpt", [(0, 4, 16), (512, 0, 16), (-1, 1, 16),
                                     (512, 4, 12), (512, 4, 64)])
def test_full_plan_refuses(monkeypatch, n, B, lpt):
    monkeypatch.setattr(tal, "FULL_LPT", lpt)
    with pytest.raises(ValueError, match="full_plan"):
        tal.full_plan(n, B)


def _meta(B=3, n=8, m=10):
    dev = torch.device("meta")
    return [torch.empty((B, n), dtype=torch.uint8, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty((B, m), dtype=torch.uint8, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev)]


@pytest.mark.parametrize("case", ["q_int32", "t_2d_cols", "lens_int64",
                                  "rows", "strided", "empty_width",
                                  "mode_3", "mixed_device"])
def test_align_scores_refuses_bad_input(case):
    """The wrapper checks its inputs before it builds or launches
    anything: on a non-CPU tensor it raises ValueError, never falls back."""
    q, ql, t, tl = _meta()
    mode = 0
    if case == "q_int32":
        q = q.to(torch.int32)
    elif case == "t_2d_cols":
        t = t.reshape(3, 5, 2)
    elif case == "lens_int64":
        ql = ql.to(torch.int64)
    elif case == "rows":
        tl = torch.empty(4, dtype=torch.int32, device="meta")
    elif case == "strided":
        q = torch.empty((3, 16), dtype=torch.uint8, device="meta")[:, ::2]
    elif case == "empty_width":
        q, ql, t, tl = _meta(n=0)
    elif case == "mode_3":
        mode = 3
    else:
        ql = torch.zeros(3, dtype=torch.int32)
    before = tal.align_scores.launches
    with pytest.raises(ValueError, match="align_scores"):
        tal.align_scores(q, ql, t, tl, mode, 1, -1, -1)
    assert tal.align_scores.launches == before
