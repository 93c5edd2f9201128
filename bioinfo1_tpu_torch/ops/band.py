"""Banded alignment score, traceback parents and exactness certificate (port of bioinfo1_tpu/ops/pallas_band.py).

Coordinates: anti-diagonal d = i + j; lane l of the W-lane band holds the
diagonal offset o = 2l - W + (d & 1), i.e. i = (d + W) // 2 - l and
j = d - i.  Up (i-1, j) comes from lane l on even d and l+1 on odd d, left
(i, j-1) from lane l-1 on even d and l on odd d; neighbours outside the
band are _NEG.  Shapes and semantics follow ``align_scores_banded``
bit for bit: W = band rounded up to 128, n_pad = round_up(max(n, 128), 128),
m_eff = round_up(max(min(m, n + W), 128), 128), the target length clamped
to m_eff, and the sweep stopped at min(q_len + t_len, n_steps + 1).

``want_parents`` adds the traceback parents in the Pallas kernel's layout:
(steps_pad // 4, B, W) uint8 with steps_pad = round_up(n_steps, 128); the
2-bit parent (0 M, 1 I, 2 D; M > I > D, first set, strictly greater,
chosen before the local clamp and the border masks) of step idx = d - 2
sits at row idx >> 2, bit 2 * (idx & 3), lane l.  Bits past a read's last
diagonal are 0; rows past it hold whatever the buffer held (the walk never
reads them).  Unlike the JAX wrapper, B is not padded to 128.

``align_scores_banded`` is the wrapper of kernels K2 (score only) and K4
(with parents), both in csrc/band_score.cu: CUDA tensors launch a kernel
(counted on ``align_scores_banded.launches`` and ``.parent_launches``, and
by path of ``band_plan`` on ``.path_launches``),
CPU tensors take ``align_scores_banded_plain``.  ``band_plan`` picks the
kernel from W alone: lanes in registers up to ``W_REG`` in one CTA, up to
``W_CLUSTER`` across the CTAs of a thread-block cluster, up to the card's
``StripCard.w_strip`` (``W_STRIP`` on an H100 SXM) in strips on
co-resident CTAs that swap halos once an epoch; above it, K2 in strips
that keep their state in device memory between launches of one epoch each
("epochs"), K4 on the scratch kernel.  ``certify`` is plain
tensor code on either device, as in the JAX package.  The port rounds
every band to 128 lanes on both devices (the JAX CPU path rounds its
realign band to 16).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import threading

import torch

from bioinfo1_tpu_torch.kernels import build
from bioinfo1_tpu_torch.ops.align import AlignOut, _check_pair

_NEG = -(2**30)       # pallas_band._NEG: safe against +gap underflow
_DASH = 45            # ord('-')
LANES = 128           # band rounding


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_shapes(n: int, m: int, band: int):
    """(W, n_pad, m_eff, n_steps) of a banded call on (B, n) x (B, m)."""
    W = _round_up(band, LANES)
    n_pad = _round_up(max(n, 128), 128)
    # The band never touches j > i + W, so the target tail beyond n + W is
    # dead weight; reads needing it fail certification anyway.
    m_eff = _round_up(max(min(m, n + W), 128), 128)
    n_steps = (n_pad - 1) + (m_eff + 1) - 1
    return W, n_pad, m_eff, n_steps


def parent_rows(n_steps: int) -> int:
    """Byte rows of the parent tensor: 4 steps per byte, the steps padded
    to a multiple of 128 (the Pallas kernel's flush chunk)."""
    return _round_up(n_steps, 128) // 4


def align_scores_banded_plain(q_bytes: torch.Tensor, q_lens: torch.Tensor,
                              t_bytes: torch.Tensor, t_lens: torch.Tensor,
                              match: int, mismatch: int, gap: int,
                              band: int = 256, mode: int = 0,
                              dash_free: bool = False,
                              want_parents: bool = False) -> AlignOut:
    """Plain PyTorch banded scores, and parents with ``want_parents`` (a
    Python loop over anti-diagonals)."""
    B, n = q_bytes.shape
    m = t_bytes.shape[1]
    dev = q_bytes.device
    W, n_pad, m_eff, n_steps = band_shapes(n, m, band)
    half = W // 2
    ql = q_lens.long()
    tl = t_lens.long().clamp(max=m_eff)
    d_stop = min(int((ql + tl).max()), n_steps + 1) if B else 0
    i_max = (d_stop + W) // 2
    # Byte of row i is q[min(i-1, n_pad-1)] (zero padding past n) for
    # i >= 1, else 0; lane l holds row i0 - l, so each diagonal's query
    # bytes are one contiguous slice of the reversed extension below.
    # Target bytes likewise: column j = d - i0 + l is ascending in l.
    q_ext = torch.zeros((B, W + i_max + 1), dtype=torch.int64, device=dev)
    q_ext[:, W + 1:W + 1 + n] = q_bytes[:, :i_max].long()
    if i_max > n_pad:
        q_ext[:, W + 1 + n_pad:] = q_ext[:, W + n_pad:W + n_pad + 1]
    q_rev = q_ext.flip(1)
    t_ext = torch.zeros((B, 2 * W + d_stop + 1), dtype=torch.int64,
                        device=dev)        # columns j <= d_stop + W
    t_cols = min(m, m_eff, W + d_stop)
    t_ext[:, W + 1:W + 1 + t_cols] = t_bytes[:, :t_cols].long()
    if W + d_stop > m_eff:
        t_ext[:, W + 1 + m_eff:] = t_ext[:, W + m_eff:W + m_eff + 1]
    init = gap if mode == 0 else 0
    lanes = torch.arange(W, device=dev)
    neg_col = torch.full((B, 1), _NEG, dtype=torch.int64, device=dev)

    h2 = torch.where(lanes == half, 0, _NEG).expand(B, W)
    h1 = torch.where((lanes == half) | (lanes == half - 1), init,
                     _NEG).expand(B, W)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    score = zero.clone()
    bc, bi, bj = torch.full_like(zero, _NEG), zero.clone(), zero.clone()
    cc, ci, rc, rj = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    goal_rows: dict = {}            # global: rows whose goal is on diagonal d
    if mode == 0:
        for b, dg in enumerate((ql + tl).tolist()):
            goal_rows.setdefault(dg, []).append(b)
    parents = None
    if want_parents:
        parents = torch.zeros((parent_rows(n_steps), B, W), dtype=torch.uint8,
                              device=dev)
        d_last = (ql + tl).clamp(max=n_steps + 1)[:, None]
    for d in range(2, d_stop + 1):
        p = d & 1
        i0 = (d + W) // 2
        i = i0 - lanes
        j = d - i
        s = q_rev.shape[1] - 1 - i0 - W
        qb = q_rev[:, s:s + W]
        s = d - i0 + W
        tb = t_ext[:, s:s + W]
        if p == 0:
            up = h1
            left = torch.cat([neg_col, h1[:, :-1]], dim=1)
        else:
            up = torch.cat([h1[:, 1:], neg_col], dim=1)
            left = h1
        diag_v = h2 + torch.where(qb == tb, match, mismatch)
        if want_parents:
            gap_l = gap if dash_free else torch.where(tb == _DASH, 0, gap)
            gap_u = gap if dash_free else torch.where(qb == _DASH, 0, gap)
            left_v = left + gap_l
            up_v = up + gap_u
            h = torch.maximum(diag_v, left_v)
            par = (left_v > diag_v).long()
            take_d = up_v > h
            h = torch.where(take_d, up_v, h)
            par = torch.where(take_d, 2, par)
            idx = d - 2
            par = torch.where(d <= d_last, par << (2 * (idx & 3)), 0)
            acc = par if idx & 3 == 0 else acc | par
            if idx & 3 == 3 or d == d_stop:
                parents[idx >> 2] = acc.to(torch.uint8)
        elif dash_free:
            h = torch.maximum(diag_v, torch.maximum(left, up) + gap)
        else:
            left_v = left + torch.where(tb == _DASH, 0, gap)
            up_v = up + torch.where(qb == _DASH, 0, gap)
            h = torch.maximum(torch.maximum(diag_v, left_v), up_v)
        if mode == 1:
            h = h.clamp(min=0)                            # local clamp
        if d < W + 2:
            # From d = W + 2 on, every band lane has i, j >= 1 (the
            # Pallas kernel's border phase ends there too).
            h = torch.where(i == 0, j * init, h)          # row 0
            h = torch.where(j == 0, i * init, h)          # column 0
            h = torch.where((i < 0) | (j < 0), _NEG, h)

        if mode == 0:
            for b in goal_rows.get(d, ()):
                # Goal (q_len, t_len) sits at lane (t_len - q_len + W - p)
                # // 2; off the band the score is 0, as in the kernel.
                ls = (int(tl[b]) - int(ql[b]) + W - p) // 2
                score[b] = h[b, ls] if 0 <= ls < W else 0
        elif mode == 1:
            valid = ((i >= 1) & (i <= ql[:, None])
                     & (j >= 1) & (j <= tl[:, None]))
            cand = torch.where(valid, h, _NEG)
            c = cand.max(dim=1).values
            lmax = torch.where(cand == c[:, None], lanes, -1).max(dim=1).values
            i_cand = i0 - lmax
            take = (c > _NEG) & ((c > bc) | ((c == bc) & (i_cand < bi)))
            bc = torch.where(take, c, bc)
            bi = torch.where(take, i_cand, bi)
            bj = torch.where(take, d - i_cand, bj)
        else:
            i_col = d - tl
            l_col = i0 - i_col
            v_col = h.gather(1, l_col.clamp(0, W - 1)[:, None])[:, 0]
            take = ((i_col >= 0) & (i_col <= ql) & (l_col >= 0)
                    & (l_col < W) & (v_col > cc))
            cc = torch.where(take, v_col, cc)
            ci = torch.where(take, i_col, ci)
            j_row = d - ql
            l_row = i0 - ql
            v_row = h.gather(1, l_row.clamp(0, W - 1)[:, None])[:, 0]
            take = ((j_row >= 0) & (j_row <= tl) & (l_row >= 0)
                    & (l_row < W) & (v_row > rc))
            rc = torch.where(take, v_row, rc)
            rj = torch.where(take, j_row, rj)
        h2, h1 = h1, h

    if mode == 0:
        out = (score, ql, tl)
    elif mode == 1:
        hit = bc > _NEG
        out = (torch.where(hit, bc, 0), torch.where(hit, bi, 0),
               torch.where(hit, bj, 0))
    else:
        row_wins = rc > cc
        out = (torch.where(row_wins, rc, cc), torch.where(row_wins, ql, ci),
               torch.where(row_wins, rj, tl))
    return AlignOut(*(x.to(torch.int32) for x in out), parents=parents)


# The kernels' dispatch (csrc/band_score.cu): by W alone.  Up to W_REG lanes
# a thread keeps LPT band lanes in registers: one warp per read ("warp",
# W == 32 * LPT, several reads per CTA, no block sync) or W / LPT threads
# per read ("warps", one read per CTA, one block sync per diagonal).  Up to
# W_CLUSTER lanes the same threads span the CTAs of a thread-block cluster
# ("cluster", one cluster per read, one cluster barrier per diagonal, the
# edge values between CTAs in distributed shared memory).  Up to the card's
# w_strip lanes (StripCard; W_STRIP on an H100 SXM) a read's band splits
# into strips of STRIP_WIDTHS lanes, one CTA each
# ("strip": the "warps" body over the strip and STRIP_HALO lanes on each
# side; the CTAs swap their edges through a global buffer once every
# STRIP_EPOCH diagonals, so all of a read's CTAs must be resident at once:
# cooperative launches of reads_per_launch reads).  Wider score-only bands
# take the same strips without co-residency ("epochs": one launch per epoch
# of 2 * EPOCH_HALO diagonals, every strip of every read, the two newest
# diagonals and the trackers in a per-read device scratch between
# launches, two slots by epoch parity; EPOCH_WIDTH lanes a strip).  Wider
# bands with parents take the scratch kernel (one CTA per read, the
# diagonals in shared memory or, past SMEM_LIMIT, a per-read global
# scratch): K4 stores W / 4 bytes a diagonal and a read sweeps at least W
# diagonals, so its parents past W_STRIP take at least W^2 / 4 > 73 GB.
W_REG = 4096
W_CLUSTER = 32768
PATHS = ("warp", "warps", "scratch", "cluster", "strip",
         "epochs")  # C's numbers
WARP_LPT = {128: 4, 256: 8}                # "warp" path: W -> LPT
WARPS_LPT = 8
MAX_READS_PER_CTA = 4
MAX_CLUSTER = 8                            # the portable cluster size
SM_COUNT = 132                             # H100
SCRATCH_THREADS = 512
STRIP_HALO = 32                # H: halo lanes on each side of a strip
STRIP_EPOCH = 2 * STRIP_HALO   # diagonals between two swaps
STRIP_WIDTHS = (1024, 2048, 4096)
STRIP_REC_INTS = 320           # csrc/band_score.cu kStripRecInts
# The "epochs" path's strips: EPOCH_WIDTH owned lanes and EPOCH_HALO
# (csrc/band_score.cu kEpochHalo) a side, from chip_smoke.py --epoch-trial
# on an NVIDIA H100 80GB HBM3 at 700 W (W = 2^20, one ~1.2 Mb read): 2,121
# ms at 2,048 lanes against 2,159 at 4,096 and 2,223 at 1,024 (halos of 64
# lanes); halos of 32 took 2,277-2,376 ms, twice the launches.
EPOCH_HALO = 64
EPOCH_WIDTH = 2048
# Static shared memory of the register kernel: four 33-entry edge arrays
# and 32 goal triples, plus two goal triples of each CTA of a cluster.
REG_SMEM_BYTES = 4 * 33 * 4 + 32 * 3 * 4 + 2 * MAX_CLUSTER * 3 * 4


@dataclasses.dataclass(frozen=True)
class StripCard:
    """What the strip plan needs to know of a card: its SMs, how many strip
    CTAs of each of STRIP_WIDTHS an SM holds at once (the least over K2
    and K4, the three modes and both variants) and the ints of a strip's
    record in the scratch (csrc/band_score.cu kStripRecInts)."""
    sms: int
    per_sm: tuple
    rec_ints: int = STRIP_REC_INTS

    def held(self, width: int) -> int:
        """Strip CTAs of ``width`` owned lanes the card holds at once."""
        return self.sms * self.per_sm[STRIP_WIDTHS.index(width)]

    @property
    def w_strip(self) -> int:
        """The widest band whose strips of one read are all resident at
        once: past it, the scratch kernel."""
        return max(self.held(S) * S for S in STRIP_WIDTHS)


# An H100 SXM: 132 SMs, each holding 4 strip CTAs of 1,024 lanes, 2 of
# 2,048 or 1 of 4,096 (cudaOccupancyMaxActiveBlocksPerMultiprocessor on
# the card).  The plan of a caller that names no card; a launch on a card
# plans with that card's own (strip_card).
H100_SXM = StripCard(SM_COUNT, (4, 2, 1))
W_STRIP = H100_SXM.w_strip     # 540,672 lanes
_strip_cards: dict = {}        # CUDA device index -> StripCard


def strip_card(dev: torch.device) -> StripCard:
    """The StripCard of CUDA device ``dev``, asked of the runtime on the
    first call for that device and kept: its SM count, the occupancy of
    every strip kernel at each width (bioinfo1_band_strip_occupancy), the
    library's record size."""
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    card = _strip_cards.get(idx)
    if card is None:
        per_sm, out = [], ctypes.c_int(0)
        where = torch.device("cuda", idx)
        for S in STRIP_WIDTHS:
            threads = (S + 2 * STRIP_HALO) // WARPS_LPT
            held = []
            for variant in itertools.product((0, 1), (0, 1, 2), (0, 1)):
                build.call("bioinfo1_band_strip_occupancy", *variant,
                           threads, ctypes.byref(out), device=where)
                held.append(out.value)
            per_sm.append(min(held))
        build.call("bioinfo1_band_strip_rec_ints", ctypes.byref(out),
                   device=where)
        card = StripCard(
            torch.cuda.get_device_properties(idx).multi_processor_count,
            tuple(per_sm), out.value)
        _strip_cards[idx] = card
    return card


@dataclasses.dataclass(frozen=True)
class BandPlan:
    path: str               # one of PATHS
    lpt: int                # band lanes a thread keeps (0: scratch path)
    threads_per_cta: int
    reads_per_cta: int
    smem_bytes: int         # shared memory of one CTA
    scratch_ints: int       # per-read int32 global scratch (0: none)
    cluster: int = 1        # CTAs per read on the "cluster" path (2-8)
    strip: int = 0          # "strip" path: owned lanes of a strip
    strips: int = 0         # "strip" / "epochs": strips (CTAs) of a read
    reads_per_launch: int = 0   # "strip" path: reads a cooperative launch
    halo: int = 0           # "epochs" path: halo lanes on each side

    @property
    def threads_per_read(self) -> int:
        return self.threads_per_cta * self.cluster // self.reads_per_cta

    def segments(self) -> list:
        """[first, end) lanes of each CTA of a read on the register paths."""
        seg = self.threads_per_cta * self.lpt // self.reads_per_cta
        return [(r * seg, (r + 1) * seg) for r in range(self.cluster)]


def cluster_shape(W: int) -> tuple:
    """(CTAs, threads per CTA) of a W-lane band on the "cluster" path: the
    fewest CTAs, at least ceil(W / W_REG), that split the W / WARPS_LPT
    threads evenly.  W is a multiple of 128, so W / 8 is one of 16, and a
    cluster of 2, 4 or 8 always splits it: every CTA has the same
    threads (one blockDim), each owning WARPS_LPT lanes, none idle."""
    nthr = W // WARPS_LPT
    for c in range(-(-W // W_REG), MAX_CLUSTER + 1):
        if nthr % c == 0:
            return c, nthr // c
    raise ValueError(f"cluster_shape: W={W} is wider than {W_CLUSTER}")


def band_plan(W: int, B: int, want_parents: bool,
              card: StripCard | None = None) -> BandPlan:
    """Which kernel of csrc/band_score.cu serves a W-lane band, and its
    launch shape.  The path depends on W alone (and, past W_CLUSTER, on
    the widest band ``card`` holds in strips, an H100 SXM when None, and
    past it on ``want_parents``: K2 takes ``epoch_plan``, K4 the scratch
    kernel); B only sets how many one-warp reads share a CTA (more once
    the reads outnumber what the card's SMs hold at one CTA each) and, on
    the strip path, the strip width and the reads a launch
    (``strip_plan``)."""
    if W % LANES or W < LANES:
        raise ValueError(f"band_plan: W={W} is not a multiple of {LANES}")
    if W in WARP_LPT:
        lpt = WARP_LPT[W]
        rpc = max(1, min(MAX_READS_PER_CTA, B // (2 * SM_COUNT)))
        return BandPlan("warp", lpt, W // lpt * rpc, rpc, REG_SMEM_BYTES, 0)
    if W <= W_REG:
        return BandPlan("warps", WARPS_LPT, W // WARPS_LPT, 1,
                        REG_SMEM_BYTES, 0)
    if W <= W_CLUSTER:
        c, threads = cluster_shape(W)
        return BandPlan("cluster", WARPS_LPT, threads, 1, REG_SMEM_BYTES, 0,
                        c)
    if W <= (card or H100_SXM).w_strip:
        return strip_plan(W, B, card)
    if not want_parents:
        return epoch_plan(W)
    return scratch_plan(W, want_parents)


def _strip_launches(W: int, B: int, width: int, card: StripCard) -> tuple:
    """(launches, reads a launch) of B reads in strips of ``width`` lanes:
    as few cooperative launches as the card holds, the reads spread
    evenly."""
    launches = -(-max(B, 1) // (card.held(width) // -(-W // width)))
    return launches, -(-max(B, 1) // launches)


def strip_cost(W: int, B: int, width: int, card: StripCard) -> int:
    """The strip path's time model, in lanes: a launch takes as long as
    its busiest SM's lanes (the owned and halo lanes of the CTAs it holds)
    need, diagonal for diagonal, and the launches run one after another.
    It orders the widths as ``chip_smoke.py --strip-trial`` timed them on
    an NVIDIA H100 80GB HBM3 at 700 W: at W = 65,536 strips of 1,024 lanes
    win for 1-2 reads (one CTA a SM), of 4,096 for 8 (one CTA a SM against
    four), and at W = 32,896 for 32 reads 1,024 in 2 launches beats 4,096
    in 3."""
    launches, per = _strip_launches(W, B, width, card)
    ctas = per * -(-W // width)
    return launches * -(-ctas // card.sms) * (width + 2 * STRIP_HALO)


def strip_plan(W: int, B: int, card: StripCard | None = None,
               width: int | None = None) -> BandPlan:
    """The strip kernel's launch shape on ``card`` (an H100 SXM when None)
    for any W that is a multiple of 128 up to its ``w_strip``
    (``band_plan`` gives it the bands past W_CLUSTER), in strips of
    ``width`` lanes (one of STRIP_WIDTHS whose strips of a read the card
    holds at once), by default the one of least ``strip_cost`` (the
    narrowest of equals); the reads go in as few launches as the card's
    CTAs allow, spread evenly."""
    card = card or H100_SXM
    if W % LANES or W < LANES or W > card.w_strip:
        raise ValueError(f"strip_plan: W={W} is no multiple of {LANES} up "
                         f"to {card.w_strip}")
    fits = [S for S in STRIP_WIDTHS if card.held(S) >= -(-W // S)]
    if width is None:
        width = min(fits, key=lambda S: strip_cost(W, B, S, card))
    if width not in fits:
        raise ValueError(f"strip_plan: strips of {width} lanes of a W={W} "
                         "band are not all resident at once")
    strips = -(-W // width)
    return BandPlan("strip", WARPS_LPT,
                    (width + 2 * STRIP_HALO) // WARPS_LPT, 1, REG_SMEM_BYTES,
                    strips * card.rec_ints, strip=width, strips=strips,
                    reads_per_launch=_strip_launches(W, B, width, card)[1])


def epoch_state_ints(W: int, strips: int) -> int:
    """Ints of one read's state on the "epochs" path (csrc/band_score.cu
    epoch_state_ints): two slots of two W-lane diagonals, 2W of trackers,
    8 of goal triples a strip."""
    return 6 * W + 8 * strips


def epoch_plan(W: int, width: int = EPOCH_WIDTH,
               halo: int = EPOCH_HALO) -> BandPlan:
    """The "epochs" kernel's launch shape (K2 only; any W that is a
    multiple of 128, ``band_plan`` gives it the score-only bands past the
    card's ``w_strip``): strips of ``width`` owned lanes, one CTA of
    (width + 2 * halo) / WARPS_LPT threads each, every strip of every read
    in each epoch's launch.  The card need not hold them at once."""
    if W % LANES or W < LANES or width % LANES or not 0 < width <= W_REG:
        raise ValueError(f"epoch_plan: W={W}, width={width}")
    strips = -(-W // width)
    return BandPlan("epochs", WARPS_LPT, (width + 2 * halo) // WARPS_LPT, 1,
                    REG_SMEM_BYTES, epoch_state_ints(W, strips),
                    strip=width, strips=strips, halo=halo)


def scratch_plan(W: int, want_parents: bool) -> BandPlan:
    """The scratch kernel's launch shape (any W; ``band_plan`` gives it
    K4's bands past the card's ``w_strip``)."""
    # Per-read state: three int32 diagonals, plus K4's W accumulator bytes
    # (csrc/band_score.cu state_ints).
    state_ints = 3 * W + (W // 4 if want_parents else 0)
    use_smem = 4 * state_ints <= build.SMEM_LIMIT
    return BandPlan("scratch", 0, min(W, SCRATCH_THREADS), 1,
                    4 * state_ints if use_smem else 0,
                    0 if use_smem else state_ints)


def align_scores_banded(q_bytes: torch.Tensor, q_lens: torch.Tensor,
                        t_bytes: torch.Tensor, t_lens: torch.Tensor,
                        match: int, mismatch: int, gap: int,
                        band: int = 256, mode: int = 0,
                        dash_free: bool = False,
                        want_parents: bool = False) -> AlignOut:
    """Banded scores for all three modes, and with ``want_parents`` the
    traceback parents: kernel K2 (K4 with parents) on CUDA tensors, the
    plain version on CPU tensors.  Exact iff ``certify`` (else a lower
    bound of the in-band optimum); only reads passing
    ``certify(strict=True)`` may trust the parents.  ``dash_free`` drops
    the literal-'-' free-gap rule; callers set it only when no input byte
    is '-'."""
    if q_bytes.device.type == "cpu":
        return align_scores_banded_plain(q_bytes, q_lens, t_bytes, t_lens,
                                         match, mismatch, gap, band, mode,
                                         dash_free, want_parents)
    _check_pair("align_scores_banded", q_bytes, q_lens, t_bytes, t_lens)
    B, n = q_bytes.shape
    m = t_bytes.shape[1]
    W, n_pad, m_eff, n_steps = band_shapes(n, m, band)
    dev = q_bytes.device
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    parents = (torch.empty((parent_rows(n_steps), B, W), dtype=torch.uint8,
                           device=dev) if want_parents else None)
    if B:
        plan = band_plan(W, B, want_parents, strip_card(dev))
        scratch = None
        if plan.scratch_ints:
            # The strip path's flags and tickets start at 0 on every call.
            scratch = (torch.zeros if plan.path == "strip" else torch.empty)(
                (B, plan.scratch_ints), dtype=torch.int32, device=dev)
        shape = {"cluster": (plan.cluster, plan.smem_bytes),
                 "strip": (plan.strip, plan.reads_per_launch),
                 "epochs": (plan.strip, plan.halo)}.get(
                     plan.path, (plan.reads_per_cta, plan.smem_bytes))
        args = [q_bytes.data_ptr(), n, n_pad, t_bytes.data_ptr(), m, m_eff,
                q_lens.data_ptr(), t_lens.data_ptr(), B, W, n_steps, mode,
                int(dash_free), match, mismatch, gap,
                0 if scratch is None else scratch.data_ptr(), out.data_ptr(),
                PATHS.index(plan.path), plan.lpt, *shape]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if want_parents:
            build.launch(align_scores_banded, "bioinfo1_band_parents", *args,
                         parents.data_ptr(), stream, device=dev,
                         counter="parent_launches")
        else:
            build.launch(align_scores_banded, "bioinfo1_band_score", *args,
                         stream, device=dev)
        with _path_lock:
            align_scores_banded.path_launches[plan.path] += 1
    return AlignOut(*out.unbind(0), parents=parents)


align_scores_banded.launches = 0          # K2
align_scores_banded.parent_launches = 0   # K4
# K2 and K4 launches by path of band_plan (the mapper launches from several
# worker threads).
align_scores_banded.path_launches = dict.fromkeys(PATHS, 0)
_path_lock = threading.Lock()


def parent_cells(parents: torch.Tensor, q_lens: torch.Tensor,
                 t_lens: torch.Tensor, m_eff: int,
                 first_row: int = 0) -> torch.Tensor:
    """(4 * S4, B, W) uint8: the 2-bit parent of every in-band cell with
    1 <= i <= q_len and 1 <= j <= min(t_len, m_eff), 255 elsewhere - the
    cells a parents tensor is defined on (what the walk of a certified read
    can read), for comparing two of them.  ``parents`` may be the byte rows
    from ``first_row`` on of a larger tensor."""
    S4, B, W = parents.shape
    dev = parents.device
    d0 = 2 + 4 * first_row
    d = torch.arange(d0, d0 + 4 * S4, device=dev, dtype=torch.int32)[:, None,
                                                                       None]
    lanes = torch.arange(W, device=dev, dtype=torch.int32)[None, None, :]
    i = (d + W) // 2 - lanes
    j = d - i
    ql = q_lens.to(torch.int32)[None, :, None]
    tl = t_lens.to(torch.int32).clamp(max=m_eff)[None, :, None]
    inside = (i >= 1) & (i <= ql) & (j >= 1) & (j <= tl)
    shifts = (2 * torch.arange(4, device=dev, dtype=torch.uint8))
    bits = (parents[:, None] >> shifts[None, :, None, None]) & 3
    bits = bits.reshape(4 * S4, B, W)
    return torch.where(inside, bits, torch.full_like(bits, 255))


def certify(score: torch.Tensor, q_bytes: torch.Tensor, q_lens: torch.Tensor,
            t_bytes: torch.Tensor, t_lens: torch.Tensor, match: int,
            mismatch: int, gap: int, band: int, strict: bool = False,
            mode: int = 0) -> torch.Tensor:
    """(B,) bool: the banded score provably equals the full DP's (see
    bioinfo1_tpu/ops/pallas_band.py certify for the bounds).  ``strict``
    also guarantees a byte-identical traceback (score strictly beats the
    bound)."""
    W = _round_up(band, LANES)
    ql = q_lens.long()
    tl = t_lens.long()
    diff = tl - ql
    # Band covers the whole matrix: the banded DP IS the full DP.
    whole = (ql <= W) & (tl <= W - 2)
    maxsub = max(match, mismatch, 0)
    if mode == 0:
        goal_in_band = (diff >= -W) & (diff <= W - 2)
        bound = maxsub * torch.minimum(ql, tl) + gap * (2 * (W - 1)
                                                        - diff.abs())
        no_dash = ~((q_bytes == _DASH).any(dim=1)
                    | (t_bytes == _DASH).any(dim=1))
        beats = (score > bound) if strict else (score >= bound)
        strong = no_dash & beats if gap < 0 else torch.zeros_like(beats)
        return goal_in_band & (whole | strong)
    bound = maxsub * torch.maximum(torch.minimum(ql, tl - (W - 1)),
                                   torch.minimum(tl, ql - (W - 1))).clamp(
                                       min=0)
    beats = (score > bound) if strict else (score >= bound)
    return whole | (beats if gap <= 0 else torch.zeros_like(beats))
