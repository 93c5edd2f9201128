"""The banded kernels' dispatch plan, and two properties their design uses.

``ops/band.band_plan`` decides, from W alone, which kernel of
csrc/band_score.cu serves a band (lanes in registers up to ``W_REG`` in one
CTA, up to ``W_CLUSTER`` over the CTAs of a thread-block cluster, up to
``W_STRIP`` in strips on co-resident CTAs; above it K2 in strips run one
epoch a launch, "epochs", and K4 on the scratch kernel) and its launch
shape; it is held here for every W a caller can ask for.  The register kernels lean on two facts of the
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
        if W <= tband.W_CLUSTER:
            assert plan.path == ("cluster" if W > tband.W_REG
                                 else ("warp", "warps")[W > 256]), W
            assert plan.lpt in (4, 8, 16)
            assert plan.lpt * plan.threads_per_read == W
            assert plan.scratch_ints == 0            # no scratch tensor
            assert plan.smem_bytes == tband.REG_SMEM_BYTES
            if plan.path == "warp":
                assert plan.threads_per_read == 32   # one warp per read
            else:
                assert plan.reads_per_cta == 1
            assert (plan.cluster > 1) == (plan.path == "cluster")
        else:
            assert plan.path == "strip", W
            assert plan.reads_per_cta == 1 and plan.lpt == 8
            assert plan.strip in tband.STRIP_WIDTHS and plan.cluster == 1
            assert plan.strips == -(-W // plan.strip)
            assert plan.threads_per_cta == plan.strip // 8 + 8
            assert plan.scratch_ints == plan.strips * tband.STRIP_REC_INTS
            assert plan.smem_bytes == tband.REG_SMEM_BYTES
    # Past the strips' limit, K2 takes the "epochs" path (its state in a
    # per-read device scratch) and K4 the scratch kernel, whose diagonals
    # live in shared memory or in global scratch, never both.
    for W in (tband.W_STRIP + 128, 2 * tband.W_STRIP):
        plan = tband.band_plan(W, B, want_parents)
        assert plan.reads_per_cta == 1
        if not want_parents:
            S, H = tband.EPOCH_WIDTH, tband.EPOCH_HALO
            assert plan.path == "epochs" and plan.lpt == 8
            assert (plan.strip, plan.strips, plan.halo) == (S, -(-W // S), H)
            assert plan.threads_per_cta == (S + 2 * H) // 8 <= 1024
            assert plan.scratch_ints == 6 * W + 8 * plan.strips
            assert plan.smem_bytes == tband.REG_SMEM_BYTES
            continue
        assert plan.path == "scratch"
        state = 3 * W + W // 4
        assert (plan.smem_bytes, plan.scratch_ints) == (0, state), W


def test_band_plan_switches_exactly_at_w_reg():
    assert tband.W_REG >= 4096 and tband.W_REG % 128 == 0
    assert tband.W_CLUSTER == tband.MAX_CLUSTER * tband.W_REG
    for parents in (False, True):
        assert tband.band_plan(tband.W_REG, 7, parents).path == "warps"
        assert tband.band_plan(tband.W_REG + 128, 7,
                               parents).path == "cluster"
        assert tband.band_plan(tband.W_CLUSTER, 7, parents).path == "cluster"
        assert tband.band_plan(tband.W_CLUSTER + 128, 7,
                               parents).path == "strip"
    # The path depends on W only; below the strips B moves nothing but the
    # reads per CTA.
    for W in (128, 256, 512, 2432, 4096, 4224, 19968, 32768, 32896):
        plans = [tband.band_plan(W, B, False) for B in (1, 37, 256, 100000)]
        assert len({p.path for p in plans}) == 1
        if W > tband.W_CLUSTER:
            continue
        assert len({(p.path, p.lpt, p.threads_per_read, p.smem_bytes,
                     p.scratch_ints, p.cluster) for p in plans}) == 1
    assert tband.band_plan(256, 100000, False).reads_per_cta > 1
    assert tband.band_plan(256, 256, False).reads_per_cta == 1


@pytest.mark.parametrize("want_parents", [False, True])
def test_cluster_plan_tiles_the_band(want_parents):
    """Every W of the cluster path: at most 8 CTAs of at most 512 threads,
    all CTAs alike (one blockDim), segments of whole threads that tile
    [0, W) exactly, no dynamic shared memory and no scratch; the fewest
    CTAs that split the threads evenly, never fewer than ceil(W / W_REG)."""
    for W in range(tband.W_REG + 128, tband.W_CLUSTER + 1, 128):
        plan = tband.band_plan(W, 11, want_parents)
        c = plan.cluster
        assert 2 <= c <= tband.MAX_CLUSTER, W
        assert -(-W // tband.W_REG) <= c, W
        assert plan.threads_per_cta <= 512 and plan.lpt == 8, W
        assert plan.threads_per_cta * c * plan.lpt == W, W
        assert all(W // 8 % k for k in range(-(-W // tband.W_REG), c)), W
        segs = plan.segments()
        assert len(segs) == c and segs[0][0] == 0 and segs[-1][1] == W
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
        assert all((e - s) % 8 == 0 and 0 < e - s <= tband.W_REG
                   for s, e in segs), W
        assert plan.scratch_ints == 0
        assert plan.smem_bytes == tband.REG_SMEM_BYTES <= 48 * 1024
    # W = 25,088 (the 50 kb reads' band) in 7 CTAs of 448
    # threads; W = 8,320 (1,040 threads, no multiple of 3) in 4 of 260.
    assert (tband.band_plan(25088, 11, False).cluster,
            tband.band_plan(25088, 11, False).threads_per_cta) == (7, 448)
    assert (tband.band_plan(8320, 11, False).cluster,
            tband.band_plan(8320, 11, False).threads_per_cta) == (4, 260)
    # At W = 8,192 and 24,576 the main diagonal (lane W / 2) starts a CTA.
    for W in (8192, 24576):
        assert W // 2 in [s for s, _ in tband.band_plan(W, 1, False)
                          .segments()]


def test_strip_plan_boundaries():
    """32,768 lanes take the cluster path, 32,896 strips, up to W_STRIP
    (the widest band whose strips of one read are all resident on an H100
    SXM at once); past it K2's "epochs" path and K4's scratch kernel.
    The kernel's halo
    needs a last strip of at least STRIP_HALO lanes and an epoch that ends
    on a parent byte."""
    card = tband.H100_SXM
    assert tband.W_STRIP == card.w_strip == 540672
    assert all(card.held(S) * S == 540672 for S in tband.STRIP_WIDTHS)
    assert tband.STRIP_EPOCH == 2 * tband.STRIP_HALO
    assert tband.STRIP_EPOCH % 4 == 0 and tband.W_CLUSTER % \
        tband.STRIP_EPOCH == 0
    for parents in (False, True):
        for B in (1, 8, 32):
            assert tband.band_plan(32768, B, parents).path == "cluster"
            assert tband.band_plan(32896, B, parents).path == "strip"
            assert tband.band_plan(tband.W_STRIP, B, parents).path == \
                "strip"
            assert tband.band_plan(tband.W_STRIP + 128, B,
                                   parents).path == ("scratch" if parents
                                                     else "epochs")
    for W in range(tband.W_CLUSTER + 128, 140000, 128 * 7):
        plan = tband.band_plan(W, 3, False)
        last = W - (plan.strips - 1) * plan.strip
        assert tband.STRIP_HALO <= last <= plan.strip, W
    # The strip kernel serves any multiple of 128 up to W_STRIP when
    # called directly (the trial times it at the cluster path's 25,088).
    plan = tband.strip_plan(25088, 11)
    assert plan.strips == -(-25088 // plan.strip) and plan.cluster == 1
    for W in (0, 100, tband.W_STRIP + 128):
        with pytest.raises(ValueError):
            tband.strip_plan(W, 1)


@pytest.mark.parametrize("W,B,width,launches", [
    (32896, 1, 1024, 1),     # 33 CTAs, one a SM
    (65536, 1, 1024, 1),     # the -c chunk of a 100 kb read: 64 CTAs
    (65536, 2, 1024, 1),     # 128 CTAs, one a SM
    (65536, 4, 2048, 1),     # 128 CTAs of 2,048 lanes, one a SM
    (65536, 8, 4096, 1),     # the 100 kb reads' score-only call
    (65536, 12, 1024, 2),    # two launches of 6 reads, 3 CTAs a SM
    (32896, 32, 1024, 2),    # the kernel table's row: 33 strips a read
    (540672, 2, 4096, 2),    # the widest band: one read a launch
])
def test_strip_width_and_read_groups(W, B, width, launches):
    """The strip width of least ``strip_cost`` on an H100 SXM: at every
    shape here the width timed fastest (``chip_smoke.py --strip-trial`` on
    an NVIDIA H100 80GB HBM3 at 700 W: at W = 65,536, 1 / 2 / 4 / 8 / 12
    reads ran 47.60 / 47.54 / 56.73 / 79.15 / 156.06 ms at these widths
    against 56.78 / 56.65 / 59.62 / 97.56 / 158.05 at the next best; at W
    = 32,896, 32 reads, 10.86 against 14.55).  The reads then go in as few
    cooperative launches as the card's CTAs allow, spread evenly, and
    every launch's CTAs fit what the card holds."""
    card = tband.H100_SXM
    plan = tband.band_plan(W, B, False)
    assert (plan.path, plan.strip) == ("strip", width)
    groups = -(-B // plan.reads_per_launch)
    assert groups == launches
    assert plan.reads_per_launch * plan.strips <= card.held(width)
    assert B - (groups - 1) * plan.reads_per_launch >= \
        plan.reads_per_launch - groups
    assert (plan.reads_per_launch + 1) * plan.strips > card.held(width) \
        or -(-B // (plan.reads_per_launch + 1)) == groups
    fits = [S for S in tband.STRIP_WIDTHS if card.held(S) >= -(-W // S)]
    costs = {S: tband.strip_cost(W, B, S, card) for S in fits}
    assert costs[width] == min(costs.values())
    assert all(costs[S] > costs[width] for S in fits if S < width)
    assert plan.threads_per_cta <= 1024 and plan.threads_per_cta % 8 == 0


def test_strip_cost_counts_the_busiest_sm_of_each_launch():
    """strip_cost: launches x the CTAs on the busiest SM of a launch x the
    lanes of a CTA (owned and halo)."""
    card = tband.H100_SXM
    # 8 reads of 64 strips of 1,024: one launch of 512 CTAs, 4 a SM.
    assert tband.strip_cost(65536, 8, 1024, card) == 1 * 4 * (1024 + 64)
    # 12 reads: 8 a launch at most, so two launches of 6 (384 CTAs, 3 a SM).
    assert tband.strip_cost(65536, 12, 1024, card) == 2 * 3 * (1024 + 64)
    # 32 reads of 9 strips of 4,096: 14 a launch, three launches of 11.
    assert tband.strip_cost(32896, 32, 4096, card) == 3 * 1 * (4096 + 64)
    # A forced width is taken as asked, in as few launches as it allows.
    plan = tband.strip_plan(65536, 8, card, width=2048)
    assert (plan.strip, plan.strips, plan.reads_per_launch) == (2048, 32, 8)
    with pytest.raises(ValueError):
        tband.strip_plan(65536, 8, tband.StripCard(16, (2, 1, 1)),
                         width=1024)


# Cards of other shapes: an H100 PCIe (114 SMs), a card whose strip
# kernels hold fewer CTAs a SM, a slice of 16 SMs.
CARDS = [tband.H100_SXM, tband.StripCard(114, (4, 2, 1)),
         tband.StripCard(132, (3, 1, 1)), tband.StripCard(16, (2, 1, 1))]


@pytest.mark.parametrize("card", CARDS, ids=lambda c: f"{c.sms}x{c.per_sm}")
def test_strip_plan_fits_the_card(card):
    """On any card the strip path takes the bands up to the card's own
    widest strip band (the scratch kernel past it), every strip width the
    plan picks holds a read's strips at once, and every cooperative launch
    fits what the card holds, its reads spread evenly over the fewest
    launches."""
    assert card.w_strip == max(card.held(S) * S for S in tband.STRIP_WIDTHS)
    for W in sorted({32896, 49152, 65536, 131072, 200064,
                     card.w_strip - 128, card.w_strip}):
        if not tband.W_CLUSTER < W <= card.w_strip:
            continue
        for B in (1, 2, 8, 37, 300):
            plan = tband.band_plan(W, B, False, card)
            assert plan.path == "strip", (W, B)
            assert plan.strips == -(-W // plan.strip)
            assert plan.strips <= card.held(plan.strip)
            per = card.held(plan.strip) // plan.strips
            assert plan.reads_per_launch <= per, (W, B)
            launches = -(-B // plan.reads_per_launch)
            assert launches == -(-B // per), (W, B)
            assert plan.scratch_ints == plan.strips * card.rec_ints
    assert tband.band_plan(card.w_strip + 128, 1, True,
                           card).path == "scratch"
    with pytest.raises(ValueError):
        tband.strip_plan(card.w_strip + 128, 1, card)


# Bands past a card's w_strip that callers ask for: the first multiple of
# 128, a fused band of the 1,572,864 bucket (cap / 2), the realign band of
# reads past ~1.1 Mb (2^20), and a band past what any read takes.
PAST = (128, 4096, 786432 - 540672, 1048576 - 540672)


@pytest.mark.parametrize("card", CARDS, ids=lambda c: f"{c.sms}x{c.per_sm}")
def test_epochs_plan_past_the_cards_w_strip(card):
    """Past the card's own w_strip, K2 plans "epochs" (every strip of every
    read in each epoch's launch: no read group, no residency) and K4 the
    scratch kernel, for any B; at and below it nothing moves: K2 and K4
    take the same plan, never "epochs"."""
    for W in sorted({card.w_strip + x for x in PAST} | {786432, 1048576}):
        if W <= card.w_strip:
            continue
        for B in (1, 2, 8, 37):
            plan = tband.band_plan(W, B, False, card)
            assert plan == tband.epoch_plan(W), (W, B)
            assert plan.path == "epochs" and plan.reads_per_launch == 0
            assert tband.band_plan(W, B, True, card) == \
                tband.scratch_plan(W, True)
    for W in (32768, 32896, 65536, card.w_strip - 128, card.w_strip):
        if W > card.w_strip:
            continue
        for B in (1, 8, 37):
            k2, k4 = (tband.band_plan(W, B, p, card) for p in (False, True))
            assert k2 == k4 and k2.path != "epochs", (W, B)


def test_epoch_plan_shape():
    """The "epochs" plan: an epoch of 2H diagonals divides 128, so it
    divides every W and W + 2 starts an epoch (each epoch is all border or
    all interior); strips of EPOCH_WIDTH lanes, the last one ragged; the
    per-read state of csrc/band_score.cu epoch_state_ints; any multiple of
    128 when called directly, strips up to W_REG lanes."""
    H = tband.EPOCH_HALO
    assert 128 % (2 * H) == 0 and H % 8 == 0
    assert tband.EPOCH_WIDTH % 128 == 0 and tband.EPOCH_WIDTH <= tband.W_REG
    for W in (128, 640, 540800, 1048576, 1048576 + 128):
        for width in (128, 1024, 4096):
            plan = tband.epoch_plan(W, width)
            assert plan.strips == -(-W // width)
            assert 0 < W - (plan.strips - 1) * width <= width
            assert plan.threads_per_cta == (width + 2 * H) // 8
            assert plan.scratch_ints == tband.epoch_state_ints(W,
                                                               plan.strips)
            assert plan.halo == H and plan.cluster == 1
    assert tband.epoch_plan(1048576, 1024, halo=32).threads_per_cta == 136
    for W, width in ((100, 128), (0, 128), (640, 100), (640, 8192)):
        with pytest.raises(ValueError):
            tband.epoch_plan(W, width)


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
