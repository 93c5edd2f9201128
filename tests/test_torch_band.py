"""Plain banded score of the port against the JAX Pallas kernel, exactly.

``bioinfo1_tpu.ops.pallas_band.align_scores_banded`` runs in interpret
mode on the CPU (as the JAX package's own map_step does there), and the
port's plain version must return the same score and goal cell for every
row, in all three modes, with and without ``dash_free``, at W = 128 and
256.  ``certify`` (strict and non-strict) must agree with JAX's too.
"""

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.ops import pallas_band as jpb
from bioinfo1_tpu_torch.ops import band as tband

SCORING = (1, -1, -1)


def _pairs(seed):
    """Near-diagonal ONT-like pairs, a 150-base deletion (drifts off a
    128 band), a target much longer than query + W (hits the m_eff clamp),
    '-' bytes on both sides, and an empty row."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(8):
        n = int(rng.integers(60, 300))
        base = letters[rng.integers(0, 4, n)]
        mut = []
        for c in base:
            x = rng.random()
            if x < 0.05:
                mut.append(letters[rng.integers(0, 4)])
            elif x < 0.08:
                mut += [c, letters[rng.integers(0, 4)]]
            elif x < 0.11:
                continue
            else:
                mut.append(c)
        pairs.append((base, np.array(mut, np.uint8)))
    base = letters[rng.integers(0, 4, 300)]
    pairs.append((base, np.concatenate([base[:100], base[250:]])))
    pairs.append((base[:90], letters[rng.integers(0, 4, 720)]))
    dq = base[:120].copy()
    dq[10:14] = ord("-")
    dt = base[:130].copy()
    dt[50:53] = ord("-")
    pairs.append((dq, dt))
    pairs.append((np.zeros(0, np.uint8), np.zeros(0, np.uint8)))
    B = len(pairs)
    n = max(len(q) for q, _ in pairs)
    m = max(len(t) for _, t in pairs)
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b, (q, t) in enumerate(pairs):
        qa[b, :len(q)], ql[b] = q, len(q)
        ta[b, :len(t)], tl[b] = t, len(t)
    return qa, ql, ta, tl


@pytest.mark.parametrize("band", [128, 256])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_banded_matches_pallas(mode, band):
    qa, ql, ta, tl = _pairs(10 * mode + band)
    assert int(tl.max()) > qa.shape[1] + 256        # the m_eff clamp bites
    for dash_free in (False, True):
        want = jax.device_get(jpb.align_scores_banded(
            qa, ql, ta, tl, *SCORING, band=band, interpret=True, mode=mode,
            dash_free=dash_free))
        got = tband.align_scores_banded(
            *(torch.from_numpy(x) for x in (qa, ql, ta, tl)), *SCORING,
            band=band, mode=mode, dash_free=dash_free)
        for f in ("score", "goal_i", "goal_j"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), getattr(want, f),
                err_msg=f"{f} dash_free={dash_free}")


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("scoring", [(1, -1, -1), (2, -1, -2), (1, -1, 0)])
def test_certify_matches_jax(mode, scoring):
    qa, ql, ta, tl = _pairs(3)
    rng = np.random.default_rng(mode)
    # Scores around the bounds, so both sides of every comparison occur.
    score = rng.integers(-300, 300, len(ql)).astype(np.int32)
    for band in (128, 256):
        for strict in (False, True):
            want = jax.device_get(jpb.certify(
                score, qa, ql, ta, tl, np.int32(scoring[0]),
                np.int32(scoring[1]), np.int32(scoring[2]), band,
                strict=strict, mode=mode))
            got = tband.certify(
                *(torch.from_numpy(x) for x in (score, qa, ql, ta, tl)),
                *scoring, band, strict=strict, mode=mode)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"band={band} {strict}")
