"""The staging geometry of kernel K5 (csrc/walk_parents.cu), on the CPU.

K5 walks each read out of shared memory, one slab of
``ops/trace.WALK_SLAB_ROWS`` parent rows ahead: slab k + 1 is staged when
the walk enters slab k, from the walk's lane and cell there, as
``_window`` (the kernel's ``stage``) says.  A step outside its staged slab
takes a slower side path, so a window too small costs time and not
exactness; this test holds the geometry to the drift bound instead.  It
replays the plain walk's path (``walk_parents_plain``: each replayed code
must equal its code) slab by slab, as the kernel keys the slabs - by the
row the walk is on, never by the step count - and asserts that every
step's parent byte, and in local mode its q / t byte, lies inside the
slab that was staged for it.

Inputs: the JAX package's parents (``pallas_band.align_scores_banded`` with
``want_parents=True`` in interpret mode) at W = 128 in all three modes, on
test_torch_band._pairs (a 150-base deletion that leaves the band, a target
past n + W, '-' bytes, an empty row) and on tie-heavy two-letter pairs with
'-' bytes under gap 0 (in global mode most reads uncertified); and an
uncertified read whose path is sent onto a parent of 3, where the walk
stays on one cell for every remaining step.  Tolerance: exact.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.ops import pallas_band as jpb
from bioinfo1_tpu_torch.ops import trace as ttr
from test_torch_band import _pairs

BAND = 128


def _tie_pairs(seed):
    """Two-letter pairs, 10% of the target flipped, '-' bytes in every
    other row, an empty query and a 1-wide matrix."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"AC", np.uint8)
    B, n, m = 10, 260, 300
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = rng.integers(100, n + 1, B).astype(np.int32)
    tl = rng.integers(100, m + 1, B).astype(np.int32)
    ql[0], tl[1] = 0, 1
    for b in range(B):
        base = letters[rng.integers(0, 2, max(ql[b], tl[b]) + 1)]
        qa[b, :ql[b]] = base[:ql[b]]
        tgt = base[:tl[b]].copy()
        flip = rng.random(tl[b]) < 0.1
        tgt[flip] = letters[rng.integers(0, 2, int(flip.sum()))]
        ta[b, :tl[b]] = tgt
        if b % 2 == 0 and ql[b] and tl[b]:
            qa[b, rng.integers(0, ql[b], 2)] = ord("-")
            ta[b, rng.integers(0, tl[b], 2)] = ord("-")
    return qa, ql, ta, tl


CASES = {"pairs": (lambda: _pairs(7), (1, -1, -1)),
         "tie_dash": (lambda: _tie_pairs(8), (1, -1, 0))}


@functools.lru_cache(maxsize=None)
def _inputs(case, mode):
    make, scoring = CASES[case]
    qa, ql, ta, tl = make()
    out = jax.device_get(jpb.align_scores_banded(
        qa, ql, ta, tl, *scoring, band=BAND, interpret=True, block=8,
        mode=mode, want_parents=True))
    cert = jax.device_get(jpb.certify(
        out.score, qa, ql, ta, tl, *(np.int32(x) for x in scoring), BAND,
        strict=True, mode=mode))
    return qa, ta, out, scoring, cert


def _window(top, lane, i, j, W, qn, tm):
    """The slab K5 stages from a walk at (i, j) on ``lane``: parent rows
    ``rows`` (top down to top - K + 1, those >= 0), lanes [lo, hi), and in
    local mode q bytes [q_lo, q_hi) and t bytes [t_lo, t_hi)."""
    K, win = ttr.WALK_SLAB_ROWS, ttr.WALK_WINDOW
    lo = max(lane - (win - 16) // 2, 0) // 16 * 16
    q_hi = min(max(i - 1, 0), qn - 1) + 1
    t_hi = min(max(j - 1, 0), tm - 1) + 1
    return {"rows": (top - K + 1, top), "lo": lo, "hi": min(lo + win, W),
            "q_lo": max(q_hi - (win - 16), 0), "q_hi": q_hi,
            "t_lo": max(t_hi - (win - 16), 0), "t_hi": t_hi}


def _row_lane(i, j, S4, W):
    d = i + j
    return (min(max(d - 2, 0), 4 * S4 - 1) >> 2,
            min(max((j - i + W - (d & 1)) >> 1, 0), W - 1))


def _replay(par, b, i, j, cost, q, t, scoring, mode):
    """Walk read b as K5 does, slab by slab; returns its codes and asserts
    every byte it reads was staged."""
    S4, _, W = par.shape
    K, (qn, tm) = ttr.WALK_SLAB_ROWS, (q.shape[1], t.shape[1])
    match, mismatch, gap = scoring

    def active():
        return cost > 0 if mode == 1 else (i > 0 or j > 0)

    codes = []
    if not active():
        return codes
    top, lane = _row_lane(i, j, S4, W)
    cur = _window(top, lane, i, j, W, qn, tm)
    nxt = _window(top - K, lane, i, j, W, qn, tm)
    for _ in range(4 * (S4 + 1)):
        if not active():
            break
        row, lane = _row_lane(i, j, S4, W)
        while row < cur["rows"][0]:          # into the next slab
            cur, nxt = nxt, _window(nxt["rows"][1] - K, lane, i, j, W,
                                    qn, tm)
        assert cur["rows"][0] <= row <= cur["rows"][1], (b, row, cur)
        assert cur["lo"] <= lane < cur["hi"], (b, row, lane, cur)
        d = i + j
        p = (int(par[row, b, lane]) >> (2 * ((d - 2) & 3))) & 3
        if mode == 1:
            qi, ti = min(max(i - 1, 0), qn - 1), min(max(j - 1, 0), tm - 1)
            assert cur["q_lo"] <= qi < cur["q_hi"], (b, qi, cur)
            assert cur["t_lo"] <= ti < cur["t_hi"], (b, ti, cur)
            qc, tc = q[b, qi], t[b, ti]
            cost -= ((match if qc == tc else mismatch) if p == 0
                     else (0 if tc == ord("-") else gap) if p == 1
                     else (0 if qc == ord("-") else gap))
        else:
            p = 1 if i == 0 else 2 if j == 0 else p
        codes.append(p)
        i -= p in (0, 2)
        j -= p in (0, 1)
    return codes


def _check_reads(par, out, qa, ta, scoring, mode):
    """Replays every read and holds its codes to the plain walk's."""
    packed = ttr.walk_parents_plain(
        *(torch.from_numpy(np.array(x)) for x in (par, out.goal_i,
                                                  out.goal_j, out.score,
                                                  qa, ta)),
        *scoring, mode).numpy()
    S4, B, _ = par.shape
    steps = 4 * (S4 + 1)
    raw = np.stack([(packed >> (2 * k)) & 3 for k in range(4)], axis=1)
    raw = raw.reshape(-1, B)[:steps]
    walked = 0
    for b in range(B):
        codes = _replay(par, b, int(out.goal_i[b]), int(out.goal_j[b]),
                        int(out.score[b]), qa, ta, scoring, mode)
        want = np.full(steps, 3, np.uint8)
        want[:len(codes)] = codes
        np.testing.assert_array_equal(raw[:, b], want, err_msg=f"read {b}")
        walked += len(codes)
    return walked


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_walk_stays_inside_staged_slabs(case, mode):
    qa, ta, out, scoring, _ = _inputs(case, mode)
    assert _check_reads(np.asarray(out.parents), out, qa, ta, scoring,
                        mode) > 1000


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_walk_stuck_on_a_parent_of_three_stays_in_its_slab(mode):
    """An uncertified read whose path meets a byte of 3 mid-walk: the walk
    emits 3 and stays on that cell for all 4 * (S4 + 1) steps, in the slab
    of that cell's row."""
    qa, ta, out, scoring, cert = _inputs("pairs", mode)
    par = np.array(out.parents)
    walks = {b: _replay(par, b, int(out.goal_i[b]), int(out.goal_j[b]),
                        int(out.score[b]), qa, ta, scoring, mode)
             for b in np.flatnonzero(~cert)}
    b = next(b for b, codes in walks.items() if len(codes) >= 60)
    # The cell the walk stands on after 40 steps: its parent -> 3.
    i, j = int(out.goal_i[b]), int(out.goal_j[b])
    for p in walks[b][:40]:
        i -= p in (0, 2)
        j -= p in (0, 1)
    row, lane = _row_lane(i, j, par.shape[0], par.shape[2])
    par[row, b, lane] |= 3 << (2 * ((i + j - 2) & 3))
    stuck = _replay(par, b, int(out.goal_i[b]), int(out.goal_j[b]),
                    int(out.score[b]), qa, ta, scoring, mode)
    assert stuck[:40] == walks[b][:40]
    assert stuck[40:] == [3] * (4 * (par.shape[0] + 1) - 40)
    _check_reads(par, out, qa, ta, scoring, mode)


def test_walk_geometry_constants():
    """A window of 8K + 16 bytes holds the 4K lanes either side of the
    walk's lane and the 8K q / t bytes that two slabs can reach, with a
    16-byte chunk of alignment slack; the ring of 4 warps (2 x (K + 2)
    x WALK_WINDOW bytes each) needs no shared-memory opt-in."""
    K, win = ttr.WALK_SLAB_ROWS, ttr.WALK_WINDOW
    assert win % 16 == 0 and win >= 8 * K + 16
    assert 4 * 2 * (K + 2) * win <= 48 * 1024
    w = _window(top=50, lane=200, i=300, j=310, W=4096, qn=400, tm=400)
    assert w["rows"] == (50 - K + 1, 50)
    assert w["lo"] % 16 == 0 and w["lo"] <= 200 - 4 * K
    assert w["hi"] >= 200 + 4 * K + 1 and w["hi"] - w["lo"] <= win
    assert w["q_hi"] == 300 and w["q_lo"] <= 300 - 8 * K
    edge = _window(top=3, lane=2, i=0, j=0, W=128, qn=5, tm=5)
    assert (edge["lo"], edge["hi"], edge["q_lo"], edge["q_hi"]) == \
        (0, 128, 0, 1)
