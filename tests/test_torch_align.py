"""Plain full-matrix score of the port against the JAX package, exactly.

The port's plain version must return the score and goal cell of both
``align.align_batch(want_parents=False)`` (the lax scan) and the Pallas
kernel ``pallas_align.align_scores`` in interpret mode, for all three
modes, with '-' bytes, empty rows and gap >= 0 scorings.
"""

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.ops import align as jal
from bioinfo1_tpu.ops import pallas_align as jpa
from bioinfo1_tpu_torch.ops import align as tal


def _pairs(seed, B=12, n=90, m=140):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT-", np.uint8)
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = rng.integers(0, n + 1, B).astype(np.int32)
    tl = rng.integers(0, m + 1, B).astype(np.int32)
    ql[0], tl[0] = 0, 0
    ql[1], tl[1] = n, m
    for b in range(B):
        # Mostly ACGT with a few '-' bytes; row 2 aligns a near-copy.
        p = [0.24, 0.24, 0.24, 0.24, 0.04]
        qa[b, :ql[b]] = letters[rng.choice(5, ql[b], p=p)]
        ta[b, :tl[b]] = letters[rng.choice(5, tl[b], p=p)]
    ta[2, :ql[2]] = qa[2, :ql[2]]
    tl[2] = max(tl[2], ql[2])
    return qa, ql, ta, tl


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("scoring", [(1, -1, -1), (2, -3, -2), (1, -1, 1)])
def test_plain_full_score_matches_jax(mode, scoring):
    qa, ql, ta, tl = _pairs(7 * mode - scoring[1])
    got = tal.align_scores(*(torch.from_numpy(x) for x in (qa, ql, ta, tl)),
                           mode, *scoring)
    lax = jax.device_get(jal.align_batch(qa, ql, ta, tl, mode, *scoring,
                                         want_parents=False))
    pallas = jax.device_get(jpa.align_scores(qa, ql, ta, tl, mode, *scoring,
                                             interpret=True))
    for f in ("score", "goal_i", "goal_j"):
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(g, getattr(lax, f), err_msg=f)
        np.testing.assert_array_equal(g, getattr(pallas, f), err_msg=f)


def _edge_pairs(seed, alphabet, B, n, m):
    """Pairs whose rows hit the edge rules: q_len + t_len in {0, 1, 2},
    q_len = 0 and t_len = 0 rows, full-width rows, '-' bytes in both
    sequences (with the ACGT- alphabet), one near-copy."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    qa = letters[rng.integers(0, len(letters), (B, n))].astype(np.uint8)
    ta = letters[rng.integers(0, len(letters), (B, m))].astype(np.uint8)
    ql = rng.integers(0, n + 1, B).astype(np.int32)
    tl = rng.integers(0, m + 1, B).astype(np.int32)
    rules = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (0, m), (n, 0),
             (n, m), (1, m), (n, 1)]
    for b, (x, y) in enumerate(rules[:B - 1]):
        ql[b], tl[b] = x, y
    ta[-1, :min(n, m)] = qa[-1, :min(n, m)]
    ql[-1], tl[-1] = n, m
    return qa, ql, ta, tl


def _three_ways(qa, ql, ta, tl, mode, scoring):
    got = tal.align_scores(*(torch.from_numpy(x) for x in (qa, ql, ta, tl)),
                           mode, *scoring)
    lax = jax.device_get(jal.align_batch(qa, ql, ta, tl, mode, *scoring,
                                         want_parents=False))
    pallas = jax.device_get(jpa.align_scores(qa, ql, ta, tl, mode, *scoring,
                                             interpret=True))
    for f in ("score", "goal_i", "goal_j"):
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(g, getattr(lax, f), err_msg=f)
        np.testing.assert_array_equal(g, getattr(pallas, f), err_msg=f)


@pytest.mark.parametrize("alphabet", [b"ACGT-", b"AC"], ids=["dash", "two"])
@pytest.mark.parametrize("scoring", [(1, -1, -1), (1, -1, 0), (2, -3, 1)],
                         ids=["gap-1", "gap0", "gap+1"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_full_score_edge_rows_match_jax(mode, scoring, alphabet):
    """The goal rules on degenerate rows, ties (a two-letter alphabet) and
    '-' bytes, under gap < 0, gap 0 and gap > 0 (positive borders)."""
    _three_ways(*_edge_pairs(31 + mode, alphabet, 14, 24, 30), mode,
                scoring)


@pytest.mark.parametrize("scoring", [(1, -1, 0), (2, -3, 1)],
                         ids=["gap0", "gap+1"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_full_score_past_one_strip_matches_jax(mode, scoring):
    """A width past one strip of K3 at 8 rows a thread (257 > 256 rows),
    with rows just past the strip edge and '-' bytes around it."""
    qa, ql, ta, tl = _edge_pairs(57 + mode, b"ACGT-", 6, 257, 290)
    ql[0], tl[0] = 257, 290
    ql[1], tl[1] = 257, 0
    ql[2], tl[2] = 256, 289
    qa[:, 254:258] = ord("-")
    ta[:, 250:254] = ord("-")
    _three_ways(qa, ql, ta, tl, mode, scoring)
