"""Banded parents and the traceback walk of the port against the JAX package.

* Parents: the port's plain ``align_scores_banded(want_parents=True)``
  against ``bioinfo1_tpu.ops.pallas_band.align_scores_banded`` with
  ``want_parents=True`` in interpret mode, at W = 128 and 256, in all three
  modes, with and without ``dash_free``, on pairs with a 150-base deletion,
  a target past n + W and '-' bytes (test_torch_band._pairs).  Scores and
  goal cells must be equal everywhere, the parents on every in-band cell
  with 1 <= i <= q_len and 1 <= j <= t_len (the bytes the walk of a
  certified read can read; other bytes are unwritten), and the strict
  certificate everywhere.
* Walk: on the same parents, the port's plain walk must be bit-equal to
  ``trace.pack_codes(trace.walk_parents(...))`` in all modes, and in modes
  0 and 2 equal to ``trace.walk_parents_pallas`` (interpret mode) after
  the skip codes are dropped, on the reads that pass the strict
  certificate (the Pallas walk reads a 256-lane window around the path,
  so it only agrees where the path stays in the band); the CIGARs decoded
  by ``native.cigar_rle_batch`` and by ``utils.cigar.cigar_from_codes``
  must agree.

Tolerance everywhere: exact.
"""

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu import native
from bioinfo1_tpu.ops import pallas_band as jpb
from bioinfo1_tpu.ops import trace as jtr
from bioinfo1_tpu.utils import cigar as cg
from bioinfo1_tpu_torch.ops import band as tband
from bioinfo1_tpu_torch.ops import trace as ttr
from test_torch_band import SCORING, _pairs

MODE_NAMES = {0: "global", 1: "local", 2: "semiGlobal"}


def _jax_parents(qa, ql, ta, tl, band, mode, dash_free):
    return jax.device_get(jpb.align_scores_banded(
        qa, ql, ta, tl, *SCORING, band=band, interpret=True, block=8,
        mode=mode, dash_free=dash_free, want_parents=True))


def _torch(*arrays):
    return [torch.from_numpy(np.array(x)) for x in arrays]


@pytest.mark.parametrize("band", [128, 256])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_banded_parents_match_pallas(mode, band):
    qa, ql, ta, tl = _pairs(10 * mode + band)
    q, qlt, t, tlt = _torch(qa, ql, ta, tl)
    m_eff = tband.band_shapes(qa.shape[1], ta.shape[1], band)[2]
    for dash_free in (False, True):
        want = _jax_parents(qa, ql, ta, tl, band, mode, dash_free)
        got = tband.align_scores_banded(q, qlt, t, tlt, *SCORING, band=band,
                                        mode=mode, dash_free=dash_free,
                                        want_parents=True)
        for f in ("score", "goal_i", "goal_j"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), getattr(want, f),
                err_msg=f"{f} dash_free={dash_free}")
        assert tuple(got.parents.shape) == want.parents.shape
        cells = tband.parent_cells(got.parents, qlt, tlt, m_eff)
        assert int((cells != 255).sum()) > 10000
        assert torch.equal(cells, tband.parent_cells(
            *_torch(want.parents), qlt, tlt, m_eff)), f"dash_free={dash_free}"
        want_cert = jax.device_get(jpb.certify(
            want.score, qa, ql, ta, tl, *(np.int32(x) for x in SCORING),
            band, strict=True, mode=mode))
        got_cert = tband.certify(got.score, q, qlt, t, tlt, *SCORING, band,
                                 strict=True, mode=mode)
        np.testing.assert_array_equal(got_cert.numpy(), want_cert)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_walk_matches_jax_walks(mode):
    band = 128
    qa, ql, ta, tl = _pairs(100 + mode)
    want = _jax_parents(qa, ql, ta, tl, band, mode, False)
    gi, gj, score = want.goal_i, want.goal_j, want.score
    packed_x = jax.device_get(jtr.pack_codes(jtr.walk_parents(
        want.parents, gi, gj, score, qa, ta, *SCORING, mode=mode,
        band=band)))
    got = ttr.walk_parents(*_torch(want.parents, gi, gj, score, qa, ta),
                           *SCORING, mode)
    np.testing.assert_array_equal(got.numpy(), packed_x)

    codes = ttr.unpack_codes(got.numpy())
    np.testing.assert_array_equal(codes, jtr.unpack_codes_np(packed_x))
    name = MODE_NAMES[mode]
    B = len(ql)
    cigars, tbs = native.cigar_rle_batch(
        got.numpy(), np.arange(B, dtype=np.int32), gi, gj, ql, tl, name)
    assert sum(len(c) > 0 for c in cigars) >= B - 2
    for b in range(B):
        assert (cigars[b], tbs[b]) == cg.cigar_from_codes(
            codes[:, b], name, int(gi[b]), int(gj[b]), int(ql[b]),
            int(tl[b])), b
    if mode == 1:
        return        # the JAX package keeps local mode on the XLA walk
    diag = jtr.unpack_codes_np(jax.device_get(jtr.walk_parents_pallas(
        want.parents, gi, gj, band=band, interpret=True)))
    cert = jax.device_get(jpb.certify(
        score, qa, ql, ta, tl, *(np.int32(x) for x in SCORING), band,
        strict=True, mode=mode))
    assert cert.sum() >= B - 3
    for b in np.flatnonzero(cert):
        np.testing.assert_array_equal(codes[:, b][codes[:, b] != 255],
                                      diag[:, b][diag[:, b] != 255],
                                      err_msg=f"read {b}")


def test_pack_codes_matches_jax():
    rng = np.random.default_rng(4)
    codes = rng.choice(np.array([0, 1, 2, 255], np.uint8), size=(37, 5))
    want = jax.device_get(jtr.pack_codes(codes))
    got = ttr.pack_codes(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttr.unpack_codes(got),
                                  jtr.unpack_codes_np(want))
