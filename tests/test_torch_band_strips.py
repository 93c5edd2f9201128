"""K2 / K4's strip path (csrc/band_score.cu ``band_strip_kernel``), replayed
on the CPU.

Past ``ops/band.W_CLUSTER`` lanes a read's band splits into strips of S
owned lanes, one CTA each.  A CTA computes a window of its strip and H halo
lanes on each side; the band's walls (lane 0's left, lane W - 1's up) take
_NEG from outside, the window's own edges _NEG too.  A wrong value at a
window's edge moves one lane inward per pair of diagonals, so the CTAs run
epochs of E = 2H diagonals alone and swap edges before every epoch but the
first: each stores its outer H owned lanes of the two newest diagonals into
slot k & 1 of an exchange buffer, publishes k, waits until both neighbours
have, and loads its halo from theirs.  The window's end lanes read their
bytes by index (row (d + q_w) / 2, column d / 2 + t_off) and the rest shift,
so every lane's bytes are right.  Only owned lanes inside the band track
goals and store parents; the strips' goals merge under the cluster path's
total order.

``strip_replay`` does all of that in numpy, every strip in lock step (a
legal schedule of the kernel), and must equal ``align_scores_banded_plain``
and the JAX package's lax ``align_banded_parents`` (the Pallas kernel's
interpret mode fails at these bands, ROADMAP C7): score, goal cell and
every parent bit of a cell inside the matrix, exactly.  ``_protocol`` plays
the flags and slots alone under random interleavings: with two slots every
load finds the epoch it waited for, with one it does not.

Inputs: S = 128-256, H = 8-32, W = 512-2,048 (one not a multiple of S);
the three modes, dash_free on and off, four scorings; reads whose last
diagonal ends an epoch, starts one, or falls inside one; goal lanes on a
strip's first and last lane; an empty read.  Tolerance: exact.
"""

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.ops import align as jal
from bioinfo1_tpu_torch.ops import band as tband
from test_torch_band import _pairs

NEG = tband._NEG
DASH = tband._DASH


def _byte(rows, idx, limit, have):
    """Byte ``idx`` (1-based, an array over the reads' axis 0) of each row
    by the kernel's padding rules: 0 below 1, the index clamped to
    ``limit``, 0 at or past ``have``."""
    k = np.minimum(idx - 1, limit - 1)
    ok = (idx >= 1) & (k < have)
    b = np.arange(rows.shape[0]).reshape((-1,) + (1,) * (idx.ndim - 1))
    return np.where(ok, rows[b, np.clip(k, 0, rows.shape[1] - 1)], 0)


def strip_replay(q, ql, t, tl, scoring, W, mode, dash_free, S, H,
                 merge_seed=0, swap=True, slots=None, order=None):
    """(score, goal_i, goal_j, parents) of K2 / K4's strip path; without
    ``swap`` the halos are never refreshed (a broken kernel).  With
    ``slots`` the schedule of K2's "epochs" path instead (parents None):
    each epoch is one launch in which the strips run one after another in
    ``order`` (lane order by default), each loading its window from slot
    k % slots of a band-lane buffer (the halo from its neighbours' owned
    lanes, _NEG past the band), its bytes on the epoch's first diagonal by
    index and its owned trackers, running the epoch alone, and storing its
    owned lanes into slot (k + 1) % slots and its trackers."""
    match, mismatch, gap = scoring
    B, n = q.shape
    m = t.shape[1]
    _, n_pad, m_eff, n_steps = tband.band_shapes(n, m, W)
    E, C, Wn, half = 2 * H, -(-W // S), S + 2 * H, W // 2
    init = gap if mode == 0 else 0
    s0 = np.arange(C) * S
    s1 = np.minimum(s0 + S, W)
    w0 = s0 - H                                     # each window's first lane
    lanes = (w0[:, None] + np.arange(Wn))[None]     # (1, C, Wn)
    owned = (lanes >= s0[None, :, None]) & (lanes < s1[None, :, None])
    ql = ql.astype(np.int64)
    tl = np.minimum(tl.astype(np.int64), m_eff)
    d_stop = np.minimum(ql + tl, n_steps + 1)
    col = (slice(None), None, None)                 # a read's scalar
    q_at = lambda i: _byte(q, i, n_pad, n)          # noqa: E731
    t_at = lambda j: _byte(t, j, m_eff, min(m, m_eff))  # noqa: E731
    q_w = (W - 2 * w0)[None, :, None]
    t_off = (1 - half + w0 + Wn - 1)[None, :, None]

    shape = (B, C, Wn)
    h2 = np.broadcast_to(np.where(lanes == half, 0, NEG), shape).copy()
    h1 = np.broadcast_to(np.where((lanes == half) | (lanes == half - 1),
                                  init, NEG), shape).copy()
    i2 = np.broadcast_to(half + 1 - lanes, shape)
    qb, tb = q_at(i2), t_at(2 - i2)                 # the bytes of diagonal 2
    best = np.full(shape, NEG, np.int64)
    best_d = np.zeros(shape, np.int64)
    cc, ci, rc, rj = (np.zeros((B, C), np.int64) for _ in range(4))
    score = np.zeros(B, np.int64)
    parents = (None if slots else
               np.zeros((tband.parent_rows(n_steps), B, W), np.uint8))
    # The owned lanes of every strip, in lane order: (strip, window column).
    own_c = np.concatenate([np.full(e - s, c) for c, (s, e)
                            in enumerate(zip(s0, s1))])
    own_x = np.concatenate([np.arange(H, H + e - s) for s, e in zip(s0, s1)])
    neg = np.full((B, 1, 1), NEG)
    reads = np.arange(B)
    acc = np.zeros(shape, np.int64)

    def step(d, cs):
        """Diagonal d of the strips ``cs`` (a slice), in place."""
        p = d & 1
        i0 = (d + W) // 2
        ln = lanes[:, cs]
        i = i0 - ln
        j = d - i
        g1, g2 = h1[:, cs], h2[:, cs]
        nb = np.broadcast_to(neg, (B, g1.shape[1], 1))
        if p == 0:
            up = g1
            left = np.concatenate([nb, g1[..., :-1]], axis=2)
            left = np.where(ln == 0, NEG, left)             # the wall
        else:
            up = np.concatenate([g1[..., 1:], nb], axis=2)
            up = np.where(ln == W - 1, NEG, up)             # the wall
            left = g1
        bq, bt = qb[:, cs], tb[:, cs]
        diag_v = g2 + np.where(bq == bt, match, mismatch)
        left_v = left + (gap if dash_free else np.where(bt == DASH, 0, gap))
        up_v = up + (gap if dash_free else np.where(bq == DASH, 0, gap))
        h = np.maximum(diag_v, left_v)
        par = (left_v > diag_v).astype(np.int64)
        take_d = up_v > h
        h = np.where(take_d, up_v, h)
        par = np.where(take_d, 2, par)
        if mode == 1:
            h = np.maximum(h, 0)
        if d < W + 2:
            h = np.where(i == 0, j * init, h)
            h = np.where(j == 0, i * init, h)
            h = np.where((i < 0) | (j < 0), NEG, h)
        live = d <= d_stop                                  # (B,)

        if parents is not None:
            idx = d - 2
            code = np.where(live[col], par << (2 * (idx & 3)), 0)
            acc[:, cs] = code if idx & 3 == 0 else acc[:, cs] | code
            store = live & ((idx & 3 == 3) | (d == d_stop))
            if store.any():
                parents[idx >> 2, store] = acc[store][:, own_c, own_x]
        c0 = cs.start or 0
        c1 = c0 + h.shape[1]
        if mode == 0:
            for b in np.flatnonzero(live & (ql + tl == d)):
                ls = (tl[b] - ql[b] + W - p) // 2
                if 0 <= ls < W and c0 <= ls // S < c1:
                    c = ls // S
                    score[b] = h[b, c - c0, ls - w0[c]]
        elif mode == 1:
            valid = (owned[:, cs] & (i >= 1) & (i <= ql[col]) & (j >= 1)
                     & (j <= tl[col]) & live[col])
            upd = valid & (h > best[:, cs])
            best[:, cs] = np.where(upd, h, best[:, cs])
            best_d[:, cs] = np.where(upd, d, best_d[:, cs])
        else:
            # The last column's cell (i = d - tl) and the last row's (j =
            # d - ql), each tracked by the strip that owns its lane.
            for cost, at, pos, lim, lane in (
                    (cc, ci, d - tl, ql, i0 - (d - tl)),
                    (rc, rj, d - ql, tl, i0 - ql)):
                c = np.clip(lane, 0, W - 1) // S
                here = (c >= c0) & (c < c1)
                v = h[reads, np.clip(c - c0, 0, c1 - c0 - 1),
                      np.clip(lane - w0[c], 0, Wn - 1)]
                upd = (live & here & (pos >= 0) & (pos <= lim) & (lane >= 0)
                       & (lane < W) & (v > cost[reads, c]))
                cost[reads[upd], c[upd]] = v[upd]
                at[reads[upd], c[upd]] = pos[upd]
        h2[:, cs], h1[:, cs] = g1, h
        if p == 0:      # target bytes move down one lane for odd d + 1
            tb[:, cs] = np.concatenate(
                [bt[..., 1:], t_at((d >> 1) + t_off[:, cs]
                                   + np.zeros((B, 1, 1), np.int64))],
                axis=2)
        else:           # query bytes move up one lane for even d + 1
            qb[:, cs] = np.concatenate(
                [q_at(((d + 1 + q_w[:, cs]) >> 1)
                      + np.zeros((B, 1, 1), np.int64)), bq[..., :-1]],
                axis=2)

    d_max = int(d_stop.max()) if B else 0
    if slots:
        # slot -> (read, ev / od, band lane): the two newest diagonals of
        # every owned lane at an epoch's start; one copy of the trackers.
        buf = np.full((slots, B, 2, W), NEG, np.int64)
        keep = [np.full((B, W), NEG, np.int64), np.zeros((B, W), np.int64),
                cc.copy(), ci.copy(), rc.copy(), rj.copy()]
        for k, d0 in enumerate(range(2, d_max + 1, E)):
            for c in (range(C) if order is None else order):
                cs = slice(c, c + 1)
                ln = lanes[0, c]
                x = slice(H, H + s1[c] - s0[c])     # its owned columns
                if k:
                    inside = (ln >= 0) & (ln < W)
                    at = np.clip(ln, 0, W - 1)
                    slot = buf[k % slots]
                    h2[:, c] = np.where(inside, slot[:, 0, at], NEG)
                    h1[:, c] = np.where(inside, slot[:, 1, at], NEG)
                    i = (d0 + W) // 2 - ln[None]
                    qb[:, c], tb[:, c] = q_at(i), t_at(d0 - i)
                    best[:, c] = np.where(owned[0, c], keep[0][:, at], NEG)
                    best_d[:, c] = np.where(owned[0, c], keep[1][:, at], 0)
                    for a, kept in zip((cc, ci, rc, rj), keep[2:]):
                        a[:, c] = kept[:, c]
                for d in range(d0, min(d0 + E, d_max + 1)):
                    step(d, cs)
                nxt = buf[(k + 1) % slots]
                nxt[:, 0, s0[c]:s1[c]] = h2[:, c, x]
                nxt[:, 1, s0[c]:s1[c]] = h1[:, c, x]
                keep[0][:, s0[c]:s1[c]] = best[:, c, x]
                keep[1][:, s0[c]:s1[c]] = best_d[:, c, x]
                for a, kept in zip((cc, ci, rc, rj), keep[2:]):
                    kept[:, c] = a[:, c]
    else:
        for d in range(2, d_max + 1):
            if swap and d > 2 and (d - 2) % E == 0:
                # The swap: both neighbours' outer H owned lanes into the
                # halo.
                for h in (h1, h2):
                    left = h[:, :-1, S:S + H].copy()
                    right = h[:, 1:, H:2 * H].copy()
                    h[:, 1:, :H] = left
                    h[:, :-1, S + H:] = right
            step(d, slice(None))

    if mode == 0:
        on = (ql + tl >= 2) & (ql + tl == d_stop)
        return (np.where(on, score, 0), ql, tl, parents)
    # Each strip's best, then the strips in the order they finish (here a
    # random one): the kernel's total order makes the order moot.
    order = np.random.default_rng(merge_seed).permutation(C)
    out = np.zeros((3, B), np.int64)
    for b in range(B):
        if mode == 1:
            g = (NEG, 0, 0)
            for c in order:
                for x in np.flatnonzero(owned[0, c]):
                    gi = (best_d[b, c, x] + W) // 2 - lanes[0, c, x]
                    cand = (best[b, c, x], gi, best_d[b, c, x] - gi)
                    if (cand[0], -cand[1], -cand[2]) > (g[0], -g[1], -g[2]):
                        g = cand
            out[:, b] = g if g[0] > NEG else (0, 0, 0)
        else:
            col_g = max(((cc[b, c], -ci[b, c]) for c in order))
            row_g = max(((rc[b, c], -rj[b, c]) for c in order))
            if row_g[0] > col_g[0]:
                out[:, b] = (row_g[0], ql[b], -row_g[1])
            else:
                out[:, b] = (col_g[0], -col_g[1], tl[b])
    return (*out, parents)


def _plain(q, ql, t, tl, scoring, W, mode, dash_free):
    out = tband.align_scores_banded_plain(
        *(torch.from_numpy(x) for x in (q, ql, t, tl)), *scoring, band=W,
        mode=mode, dash_free=dash_free, want_parents=True)
    return (out.score.numpy(), out.goal_i.numpy(), out.goal_j.numpy(),
            out.parents)


def _lax_cells(q, ql, t, tl, scoring, W, mode):
    """The JAX lax banded DP: (score, goal_i, goal_j) and its parent codes
    as (steps, B, W) (16 lanes a uint32 word, diagonal d at row d - 2)."""
    out = jax.device_get(jal.align_banded_parents(q, ql, t, tl, *scoring,
                                                  band=W, mode=mode))
    words = np.asarray(out.parents)
    lane = np.arange(W)
    codes = (words[:, :, lane // 16] >> (2 * (lane % 16)).astype(
        np.uint32)) & 3
    return (np.asarray(out.score), np.asarray(out.goal_i),
            np.asarray(out.goal_j)), codes.astype(np.uint8)


def _cells(parents, ql, tl, m_eff):
    return tband.parent_cells(torch.from_numpy(np.ascontiguousarray(parents)),
                              torch.from_numpy(ql), torch.from_numpy(tl),
                              m_eff).numpy()


def _same(got, want, ql, tl, m_eff, what):
    for k, f in enumerate(("score", "goal_i", "goal_j")):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=f"{f} vs {what}")
    if got[3] is None:
        return                                           # K2: no parents
    a = _cells(got[3], ql, tl, m_eff)
    b = _cells(np.asarray(want[3]), ql, tl, m_eff)
    assert int((a != 255).sum()) > 1000
    np.testing.assert_array_equal(a, b, err_msg=f"parents vs {what}")


def _edge_pairs(seed, W, S, H):
    """ONT-like pairs (5% substitutions, 3% insertions, 3% deletions), one
    with a 60-base deletion, '-' bytes on both sides, an empty read, and
    identical-prefix pairs whose goal lane is a strip's first or last lane
    (the edge nearest the main diagonal) or whose last diagonal ends an
    epoch (ql + tl = 1 + 3E), starts one (2 + 2E) or falls inside one."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    base = letters[rng.integers(0, 4, 400)]
    pairs = []
    for _ in range(5):
        ln = int(rng.integers(120, 230))
        ref = letters[rng.integers(0, 4, ln)]
        read = []
        for c in ref:
            x = rng.random()
            if x < 0.05:
                read.append(letters[rng.integers(0, 4)])
            elif x < 0.08:
                read += [c, letters[rng.integers(0, 4)]]
            elif x >= 0.11:
                read.append(c)
        pairs.append((np.array(read, np.uint8), ref))
    pairs.append((base[:200], np.concatenate([base[:80], base[140:260]])))
    dq, dt = base[:150].copy(), base[:160].copy()
    dq[10:14], dt[50:53] = DASH, DASH
    pairs.append((dq, dt))
    pairs.append((base[:0], base[:0]))
    E = 2 * H
    edge = S * round(W / 2 / S)
    pairs += [(base[:240], base[:240 + 2 * edge - W]),
              (base[:240], base[:238 + 2 * edge - W]),
              (base[:3 * E // 2 + 1], base[:3 * E // 2]),
              (base[:E + 1], base[:E + 1])]
    B = len(pairs)
    n = max(len(x) for x, _ in pairs)
    m = max(len(y) for _, y in pairs)
    q = np.zeros((B, n), np.uint8)
    t = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b, (x, y) in enumerate(pairs):
        q[b, :len(x)], ql[b] = x, len(x)
        t[b, :len(y)], tl[b] = y, len(y)
    return q, ql, t, tl


CASES = [  # W, S, H
    (512, 128, 32),      # four strips; the main diagonal on a strip edge
    (640, 256, 16),      # W not a multiple of S: a last strip of 128
    (2048, 256, 8),      # eight strips, epochs of 16 diagonals
]


# The schedules: the strip path's swap (every strip in lock step), and K2's
# "epochs" path (two slots, the strips of a launch in lane order and in a
# shuffled one; score and goal only, no parents).
SCHEDULES = {"swap": {}, "epochs": {"slots": 2},
             "epochs_shuffled": {"slots": 2, "order": "shuffled"}}


def _schedule(name, W, S, seed):
    kw = dict(SCHEDULES[name])
    if kw.get("order") == "shuffled":
        kw["order"] = np.random.default_rng(seed).permutation(-(-W // S))
    return kw


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("W,S,H", CASES)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_strip_replay_matches_plain_and_jax(mode, W, S, H, schedule):
    q, ql, t, tl = _edge_pairs(7 * W + mode, W, S, H)
    assert int((ql + tl).max()) > 8 * H                 # several epochs
    m_eff = tband.band_shapes(q.shape[1], t.shape[1], W)[2]
    assert int(tl.max()) <= q.shape[1] + W               # lax's m_eff too
    scoring = (1, -1, -1)
    kw = _schedule(schedule, W, S, mode)
    # dash_free on the first case only (the plain version applies it; the
    # lax DP has the '-' rule always).
    for dash_free in (False, True)[:1 + (W == CASES[0][0])]:
        got = strip_replay(q, ql, t, tl, scoring, W, mode, dash_free, S, H,
                           merge_seed=mode, **kw)
        _same(got, _plain(q, ql, t, tl, scoring, W, mode, dash_free), ql, tl,
              m_eff, f"plain dash_free={dash_free}")
        if dash_free:
            continue
        lax_out, lax_codes = _lax_cells(q, ql, t, tl, scoring, W, mode)
        for k, f in enumerate(("score", "goal_i", "goal_j")):
            np.testing.assert_array_equal(got[k], lax_out[k], err_msg=f)
        if got[3] is None:
            continue                                     # K2: no parents
        mine = _cells(got[3], ql, tl, m_eff)
        rows = min(mine.shape[0], lax_codes.shape[0])
        inside = mine[:rows] != 255
        np.testing.assert_array_equal(mine[:rows][inside],
                                      lax_codes[:rows][inside])


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("scoring", [(1, -1, 0), (1, -1, 1), (2, -3, -2)])
def test_strip_replay_under_tie_heavy_scorings(scoring, schedule):
    """Gap 0 and gap > 0 (no certificate: many ties in every mode) and a
    scoring of other weights, at W = 512 in strips of 128."""
    W, S, H = 512, 128, 32
    q, ql, t, tl = (x[5:] for x in _edge_pairs(99, W, S, H))
    m_eff = tband.band_shapes(q.shape[1], t.shape[1], W)[2]
    for mode in (0, 1, 2):
        got = strip_replay(q, ql, t, tl, scoring, W, mode, False, S, H,
                           merge_seed=3 + mode,
                           **_schedule(schedule, W, S, mode))
        _same(got, _plain(q, ql, t, tl, scoring, W, mode, False), ql, tl,
              m_eff, f"plain mode={mode}")


def test_strip_replay_needs_the_swap():
    """Without the swap (halos never refreshed) a strip sees only its own
    window: a read whose path leaves the goal's strip by 30 lanes (a
    60-base insertion, 300 bases on, a 60-base deletion) and comes back
    scores less.  The schedule, not the band's width, keeps the owned
    lanes exact."""
    W, S, H = 512, 128, 8
    rng = np.random.default_rng(8)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 500)]
    detour = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 60)]
    q = np.concatenate([g[:70], detour, g[70:370], g[430:500]])[None]
    t = g[None].copy()
    ql = tl = np.array([500], np.int32)
    want = _plain(q, ql, t, tl, (1, -1, -1), W, 0, False)
    assert int(want[0][0]) >= 440 - 120      # the detour: 440 M, 120 gaps
    got = strip_replay(q, ql, t, tl, (1, -1, -1), W, 0, False, S, H)
    assert got[0][0] == want[0][0]
    stale = strip_replay(q, ql, t, tl, (1, -1, -1), W, 0, False, S, H,
                         swap=False)
    assert stale[0][0] < want[0][0]


def _detour():
    """A read whose path leaves the goal's strip by 30 lanes (a 60-base
    insertion, 300 bases on, a 60-base deletion) and comes back."""
    rng = np.random.default_rng(8)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 500)]
    detour = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 60)]
    q = np.concatenate([g[:70], detour, g[70:370], g[430:500]])[None]
    ql = tl = np.array([500], np.int32)
    return q, ql, g[None].copy(), tl


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_epochs_need_two_slots(order):
    """K2's "epochs" path with one slot: a strip that runs before its
    neighbour in a launch overwrites the lanes the neighbour's halo still
    has to load, so the neighbour starts its epoch from diagonals an epoch
    too new, and the detour read scores wrong; with two slots the same
    order gives the plain version's score.  Which neighbour goes first
    decides which halo goes stale: both orders fail."""
    W, S, H = 512, 128, 8
    q, ql, t, tl = _detour()
    want = _plain(q, ql, t, tl, (1, -1, -1), W, 0, False)
    order = np.arange(W // S)[::1 if order == "forward" else -1]
    got = strip_replay(q, ql, t, tl, (1, -1, -1), W, 0, False, S, H,
                       slots=2, order=order)
    assert got[0][0] == want[0][0]
    one = strip_replay(q, ql, t, tl, (1, -1, -1), W, 0, False, S, H,
                       slots=1, order=order)
    assert one[0][0] != want[0][0]


def _protocol(strips, epochs, slots, rng):
    """Flags and exchange slots under a random interleaving of the CTAs:
    (the epoch each halo load found, the epoch it waited for) for every
    load.  A CTA before epoch k (k >= 1) stores into slot k % slots,
    publishes k, waits for both neighbours' flags >= k, then loads."""
    flag = [0] * strips
    slot = [[None] * slots for _ in range(strips)]
    step = [("store", 1)] * strips          # each CTA's next action
    found = []
    while any(s is not None for s in step):
        ready = []
        for c, s in enumerate(step):
            if s is None:
                continue
            what, k = s
            if what == "load" and any(flag[x] < k for x in (c - 1, c + 1)
                                      if 0 <= x < strips):
                continue
            ready.append(c)
        c = ready[rng.integers(len(ready))]
        what, k = step[c]
        if what == "store":
            slot[c][k % slots] = k
            flag[c] = k
            step[c] = ("load", k)
        else:
            for x in (c - 1, c + 1):
                if 0 <= x < strips:
                    found.append((slot[x][k % slots], k))
            step[c] = ("store", k + 1) if k < epochs else None
    return found


def test_two_exchange_slots_always_hold_the_epoch_waited_for():
    rng = np.random.default_rng(0)
    for strips in (2, 3, 5):
        for _ in range(200):
            found = _protocol(strips, 6, 2, rng)
            assert all(got == want for got, want in found)
    # One slot is not enough: a neighbour a swap ahead overwrites it.
    late = [got != want for _ in range(200)
            for got, want in _protocol(3, 6, 1, rng)]
    assert any(late)
