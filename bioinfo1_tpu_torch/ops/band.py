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
(counted on ``align_scores_banded.launches`` and ``.parent_launches``),
CPU tensors take ``align_scores_banded_plain``.  ``band_plan`` picks the
kernel from W alone: lanes in registers up to ``W_REG``, the scratch
kernel above.  ``certify`` is plain
tensor code on either device, as in the JAX package.  The port rounds
every band to 128 lanes on both devices (the JAX CPU path rounds its
realign band to 16).
"""

from __future__ import annotations

import dataclasses

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
# per read ("warps", one read per CTA, one block sync per diagonal).  Wider
# bands take the scratch kernel (one CTA per read, the diagonals in shared
# memory or, past SMEM_LIMIT, a per-read global scratch).
W_REG = 4096
PATHS = ("warp", "warps", "scratch")       # the C launcher's path numbers
WARP_LPT = {128: 4, 256: 8}                # "warp" path: W -> LPT
WARPS_LPT = 8
MAX_READS_PER_CTA = 4
SM_COUNT = 132                             # H100
SCRATCH_THREADS = 512
# Static shared memory of the register kernel: four 32-entry warp-edge
# arrays and 32 goal triples.
REG_SMEM_BYTES = 4 * 32 * 4 + 32 * 3 * 4


@dataclasses.dataclass(frozen=True)
class BandPlan:
    path: str               # one of PATHS
    lpt: int                # band lanes a thread keeps (0: scratch path)
    threads_per_read: int
    reads_per_cta: int
    smem_bytes: int         # shared memory of one CTA
    scratch_ints: int       # per-read int32 global scratch (0: none)

    @property
    def threads_per_cta(self) -> int:
        return self.threads_per_read * self.reads_per_cta


def band_plan(W: int, B: int, want_parents: bool) -> BandPlan:
    """Which kernel of csrc/band_score.cu serves a W-lane band, and its
    launch shape.  The path depends on W alone; B only sets how many
    one-warp reads share a CTA (more once the reads outnumber what the
    card's SMs hold at one CTA each)."""
    if W % LANES or W < LANES:
        raise ValueError(f"band_plan: W={W} is not a multiple of {LANES}")
    if W in WARP_LPT:
        lpt = WARP_LPT[W]
        rpc = max(1, min(MAX_READS_PER_CTA, B // (2 * SM_COUNT)))
        return BandPlan("warp", lpt, W // lpt, rpc, REG_SMEM_BYTES, 0)
    if W <= W_REG:
        return BandPlan("warps", WARPS_LPT, W // WARPS_LPT, 1,
                        REG_SMEM_BYTES, 0)
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
        plan = band_plan(W, B, want_parents)
        scratch = (torch.empty((B, plan.scratch_ints), dtype=torch.int32,
                               device=dev) if plan.scratch_ints else None)
        args = [q_bytes.data_ptr(), n, n_pad, t_bytes.data_ptr(), m, m_eff,
                q_lens.data_ptr(), t_lens.data_ptr(), B, W, n_steps, mode,
                int(dash_free), match, mismatch, gap,
                0 if scratch is None else scratch.data_ptr(), out.data_ptr(),
                PATHS.index(plan.path), plan.lpt, plan.reads_per_cta,
                plan.smem_bytes]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if want_parents:
            build.launch(align_scores_banded, "bioinfo1_band_parents", *args,
                         parents.data_ptr(), stream,
                         counter="parent_launches")
        else:
            build.launch(align_scores_banded, "bioinfo1_band_score", *args,
                         stream)
    return AlignOut(*out.unbind(0), parents=parents)


align_scores_banded.launches = 0          # K2
align_scores_banded.parent_launches = 0   # K4


def parent_cells(parents: torch.Tensor, q_lens: torch.Tensor,
                 t_lens: torch.Tensor, m_eff: int) -> torch.Tensor:
    """(4 * S4, B, W) uint8: the 2-bit parent of every in-band cell with
    1 <= i <= q_len and 1 <= j <= min(t_len, m_eff), 255 elsewhere - the
    cells a parents tensor is defined on (what the walk of a certified read
    can read), for comparing two of them."""
    S4, B, W = parents.shape
    dev = parents.device
    d = torch.arange(2, 4 * S4 + 2, device=dev, dtype=torch.int32)[:, None,
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
