"""The banded kernels' dispatch plan, and two properties their design uses.

``ops/band.band_plan`` decides, from W alone, which kernel of
csrc/band_score.cu serves a band (lanes in registers up to ``W_REG``, the
scratch kernel above) and its launch shape; it is held here for every W a
caller can ask for.  The register kernels lean on two facts of the
function itself, pinned on the port's plain version and on the JAX Pallas
kernel in interpret mode (as ``tests/test_torch_band.py`` runs it), exact
equality:

(a) bytes past ``q_len`` / ``t_len`` change neither score, goal cell nor
    the parents on ``parent_cells``, in any mode: a kernel may compute or
    skip the cells past a read's matrix;
(b) from d = W + 2 on no band lane has i < 1 or j < 1: the border masks
    can be dropped there.
"""

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.ops import pallas_band as jpb
from bioinfo1_tpu_torch.kernels import build
from bioinfo1_tpu_torch.ops import band as tband
from test_torch_band import SCORING, _pairs

ALL_W = range(128, 65536 + 1, 128)


@pytest.mark.parametrize("B", [1, 256, 5000])
@pytest.mark.parametrize("want_parents", [False, True])
def test_band_plan_every_width(want_parents, B):
    for W in ALL_W:
        plan = tband.band_plan(W, B, want_parents)
        assert plan.path in tband.PATHS
        assert plan.threads_per_cta <= 1024, W
        assert plan.smem_bytes <= build.SMEM_LIMIT, W
        assert 1 <= plan.reads_per_cta <= tband.MAX_READS_PER_CTA
        if W <= tband.W_REG:
            assert plan.path in ("warp", "warps"), W
            assert plan.lpt in (4, 8, 16)
            assert plan.lpt * plan.threads_per_read == W
            assert plan.scratch_ints == 0            # no scratch tensor
            assert plan.smem_bytes == tband.REG_SMEM_BYTES
            if plan.path == "warp":
                assert plan.threads_per_read == 32   # one warp per read
            else:
                assert plan.reads_per_cta == 1
        else:
            assert plan.path == "scratch", W
            assert plan.reads_per_cta == 1
            state = 3 * W + (W // 4 if want_parents else 0)
            # The diagonals live in shared memory or in global scratch,
            # never both.
            assert (plan.smem_bytes, plan.scratch_ints) in (
                (4 * state, 0), (0, state)), W
            assert (plan.scratch_ints == 0) == \
                (4 * state <= build.SMEM_LIMIT)


def test_band_plan_switches_exactly_at_w_reg():
    assert tband.W_REG >= 4096 and tband.W_REG % 128 == 0
    for parents in (False, True):
        assert tband.band_plan(tband.W_REG, 7, parents).path == "warps"
        assert tband.band_plan(tband.W_REG + 128, 7,
                               parents).path == "scratch"
    # The path depends on W only; B moves nothing but the reads per CTA.
    for W in (128, 256, 512, 2432, 4096, 4224, 19968):
        plans = [tband.band_plan(W, B, False) for B in (1, 37, 256, 100000)]
        assert len({(p.path, p.lpt, p.threads_per_read, p.smem_bytes,
                     p.scratch_ints) for p in plans}) == 1
    assert tband.band_plan(256, 100000, False).reads_per_cta > 1
    assert tband.band_plan(256, 256, False).reads_per_cta == 1


@pytest.mark.parametrize("W", [0, 100, 130, -128])
def test_band_plan_rejects_a_band_that_is_no_multiple_of_128(W):
    with pytest.raises(ValueError):
        tband.band_plan(W, 4, False)


def test_trial_defines_reach_nvcc_and_the_source_hash(monkeypatch):
    """chip_smoke.py --lpt-trial builds extra K2 / K4 instantiations through
    BIOINFO1_NVCC_DEFINES; a library built without them must not be taken
    for one built with them."""
    monkeypatch.delenv("BIOINFO1_NVCC_DEFINES", raising=False)
    plain_flags, plain_hash = build.nvcc_flags(), build.source_hash()
    assert plain_flags == build.NVCC_FLAGS
    monkeypatch.setenv("BIOINFO1_NVCC_DEFINES", "BIOINFO1_BAND_LPT_TRIAL")
    assert build.nvcc_flags() == plain_flags + ("-DBIOINFO1_BAND_LPT_TRIAL",)
    assert build.source_hash() != plain_hash
    with open(build.CSRC + "/band_score.cu") as fh:
        assert "#ifdef BIOINFO1_BAND_LPT_TRIAL" in fh.read()


def _scribble(a, lens, seed):
    """A copy of ``a`` with every byte past its row's length replaced:
    letters, '-' and NUL, so a dependence on them would show."""
    rng = np.random.default_rng(seed)
    out = a.copy()
    junk = np.frombuffer(b"ACGT-\0", np.uint8)[
        rng.integers(0, 6, a.shape)]
    past = np.arange(a.shape[1])[None, :] >= lens[:, None]
    out[past] = junk[past]
    return out


def _plain(qa, ql, ta, tl, band, mode, dash_free):
    out = tband.align_scores_banded(
        *(torch.from_numpy(x) for x in (qa, ql, ta, tl)), *SCORING,
        band=band, mode=mode, dash_free=dash_free, want_parents=True)
    return out, out.parents


def _pallas(qa, ql, ta, tl, band, mode, dash_free):
    out = jax.device_get(jpb.align_scores_banded(
        qa, ql, ta, tl, *SCORING, band=band, interpret=True, block=8,
        mode=mode, dash_free=dash_free, want_parents=True))
    return out, torch.from_numpy(np.array(out.parents))


@pytest.mark.parametrize("impl", ["plain", "pallas"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bytes_past_the_lengths_change_nothing(mode, impl):
    run = _plain if impl == "plain" else _pallas
    band = 128
    qa, ql, ta, tl = _pairs(40 + mode)
    # The inputs' own padding is NUL; '-' past the lengths would defeat
    # dash_free's premise, so it is tested only on the general variant.
    qb, tb = _scribble(qa, ql, 1), _scribble(ta, tl, 2)
    assert (qa != qb).any() and (ta != tb).any()
    m_eff = tband.band_shapes(qa.shape[1], ta.shape[1], band)[2]
    qlt, tlt = torch.from_numpy(ql), torch.from_numpy(tl)
    a, a_par = run(qa, ql, ta, tl, band, mode, False)
    b, b_par = run(qb, ql, tb, tl, band, mode, False)
    for f in ("score", "goal_i", "goal_j"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    cells = tband.parent_cells(a_par, qlt, tlt, m_eff)
    assert int((cells != 255).sum()) > 10000
    assert torch.equal(cells, tband.parent_cells(b_par, qlt, tlt, m_eff))


@pytest.mark.parametrize("W", [128, 256, 2432, 4096])
def test_no_border_lane_from_diagonal_w_plus_2(W):
    lanes = np.arange(W)
    for d in range(2, 3 * W):
        i = (d + W) // 2 - lanes
        j = d - i
        on_border = bool(((i < 1) | (j < 1)).any())
        if d >= W + 2:
            assert not on_border, d
        elif d <= W:
            assert on_border, d          # the general body is needed here


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_border_masks_are_idle_from_diagonal_w_plus_2(mode):
    """The plain version drops the border masks at d = W + 2 (the Pallas
    kernel's border phase ends there too) and both agree on pairs whose
    sweeps run far past it: held by value, not only by index algebra."""
    band = 128
    qa, ql, ta, tl = _pairs(50 + mode)
    assert int((ql + np.minimum(tl, 512)).max()) > 3 * band
    got, _ = _plain(qa, ql, ta, tl, band, mode, True)
    want, _ = _pallas(qa, ql, ta, tl, band, mode, True)
    for f in ("score", "goal_i", "goal_j"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
