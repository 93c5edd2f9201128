"""Full-matrix alignment score (port of bioinfo1_tpu/ops/align.py, score-only, and ops/pallas_align.py).

The batched anti-diagonal DP of team::Align (team_alignment.cpp:49-350) in
all three modes, score and goal cell only (PAF column 10 is the DP score):
  * linear gap, a literal '-' byte costs 0 (team_alignment.cpp:25-28),
  * raw byte compare for match/mismatch,
  * global: i*gap borders, goal (n, m);
  * local: zero borders, negatives clamped, goal = first strictly-greater
    max in row-major order (smallest i, then smallest j);
  * semiGlobal: zero borders, goal = rim argmax over the last column
    (i ascending), then the last row (j ascending, strictly greater).

``align_scores`` is the wrapper of kernel K3 (csrc/full_score.cu): CUDA
tensors launch the kernel, CPU tensors take ``align_scores_plain`` (a
Python loop over anti-diagonals in place of the JAX ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bioinfo1_tpu_torch.kernels import build

MODE_GLOBAL, MODE_LOCAL, MODE_SEMIGLOBAL = 0, 1, 2
MODE_BY_NAME = {"global": MODE_GLOBAL, "local": MODE_LOCAL,
                "semiGlobal": MODE_SEMIGLOBAL}

_NEG = -(2**31) + 2   # pallas_align._NEG
_DASH = 45            # ord('-')


@dataclasses.dataclass
class AlignOut:
    """score, goal_i, goal_j: (B,) int32 (the traceback start cell);
    parents: the banded traceback parents when asked for (ops/band.py),
    else None."""

    score: torch.Tensor
    goal_i: torch.Tensor
    goal_j: torch.Tensor
    parents: Optional[torch.Tensor] = None


def align_scores_plain(q_bytes: torch.Tensor, q_lens: torch.Tensor,
                       t_bytes: torch.Tensor, t_lens: torch.Tensor,
                       mode: int, match: int, mismatch: int,
                       gap: int) -> AlignOut:
    """Plain PyTorch full-matrix scores: (B, n) query rows against (B, m)
    target rows, lane i of each diagonal holding cell (i, d - i)."""
    B, n = q_bytes.shape
    m = t_bytes.shape[1]
    n1 = n + 1
    dev = q_bytes.device
    init = gap if mode == MODE_GLOBAL else 0
    lanes = torch.arange(n1, device=dev)
    rows = torch.arange(B, device=dev)
    q_sh = torch.zeros((B, n1), dtype=torch.int64, device=dev)
    q_sh[:, 1:] = q_bytes.long()
    t64 = t_bytes.long()
    del_cost = torch.where(q_sh == _DASH, 0, gap)
    ql = q_lens.long()
    tl = t_lens.long()

    h2 = torch.zeros((B, n1), dtype=torch.int64, device=dev)   # d = 0
    h1 = torch.zeros((B, n1), dtype=torch.int64, device=dev)   # d = 1
    h1[:, :2] = init
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    score = zero.clone()
    bc, bi, bj = torch.full_like(zero, _NEG), zero.clone(), zero.clone()
    cc, ci, rc, rj = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    # Every goal rule reads only cells with d <= q_len + t_len.
    d_stop = int((ql + tl).max()) if B else 0
    for d in range(2, d_stop + 1):
        j = d - lanes
        tdiag = torch.where(j >= 1, t64[:, (j - 1).clamp(0, m - 1)], 0)
        sub = torch.where(q_sh == tdiag, match, mismatch)
        ins_cost = torch.where(tdiag == _DASH, 0, gap)
        diag_v = torch.roll(h2, 1, dims=1) + sub
        up_v = torch.roll(h1, 1, dims=1) + del_cost
        left_v = h1 + ins_cost
        h = torch.maximum(torch.maximum(diag_v, left_v), up_v)
        h = torch.where(lanes == 0, d * init, h)          # cell (0, d)
        h = torch.where(lanes == d, lanes * init, h)      # cell (d, 0)
        if mode == MODE_LOCAL:
            h = h.clamp(min=0)

        if mode == MODE_GLOBAL:
            val = h[rows, ql.clamp(0, n1 - 1)]
            score = torch.where(d == ql + tl, val, score)
        elif mode == MODE_LOCAL:
            in_diag = ((lanes >= 1) & (lanes <= ql[:, None])
                       & (j >= 1) & (j <= tl[:, None]))
            cand = torch.where(in_diag, h, _NEG)
            c = cand.max(dim=1).values
            cil = torch.where(cand == c[:, None], lanes, n1).min(dim=1).values
            cjl = d - cil
            take = (c > bc) | ((c == bc) & ((cil < bi)
                                            | ((cil == bi) & (cjl < bj))))
            bc = torch.where(take, c, bc)
            bi = torch.where(take, cil, bi)
            bj = torch.where(take, cjl, bj)
        else:
            i_col = d - tl
            v_col = h[rows, i_col.clamp(0, n1 - 1)]
            take = (i_col >= 0) & (i_col <= ql) & (v_col > cc)
            cc = torch.where(take, v_col, cc)
            ci = torch.where(take, i_col, ci)
            j_row = d - ql
            v_row = h[rows, ql.clamp(0, n1 - 1)]
            take = (j_row >= 0) & (j_row <= tl) & (v_row > rc)
            rc = torch.where(take, v_row, rc)
            rj = torch.where(take, j_row, rj)
        h2, h1 = h1, h

    if mode == MODE_GLOBAL:
        out = (score, ql, tl)
    elif mode == MODE_LOCAL:
        hit = bc > _NEG
        out = (torch.where(hit, bc, 0), torch.where(hit, bi, 0),
               torch.where(hit, bj, 0))
    else:
        row_wins = rc > cc
        out = (torch.where(row_wins, rc, cc), torch.where(row_wins, ql, ci),
               torch.where(row_wins, rj, tl))
    return AlignOut(*(x.to(torch.int32) for x in out))


def _check_pair(fn: str, q_bytes, q_lens, t_bytes, t_lens) -> None:
    B = q_bytes.shape[0]
    for name, x, dtype, ndim in (("q_bytes", q_bytes, torch.uint8, 2),
                                 ("t_bytes", t_bytes, torch.uint8, 2),
                                 ("q_lens", q_lens, torch.int32, 1),
                                 ("t_lens", t_lens, torch.int32, 1)):
        if (x.dtype != dtype or x.dim() != ndim or x.shape[0] != B
                or not x.is_contiguous() or x.device != q_bytes.device):
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} "
                             f"{ndim}-D tensor with {B} rows on "
                             f"{q_bytes.device}")
    if q_bytes.shape[1] < 1 or t_bytes.shape[1] < 1:
        raise ValueError(f"{fn}: empty query or target width")


def align_scores(q_bytes: torch.Tensor, q_lens: torch.Tensor,
                 t_bytes: torch.Tensor, t_lens: torch.Tensor, mode: int,
                 match: int, mismatch: int, gap: int) -> AlignOut:
    """Full-matrix scores: kernel K3 on CUDA tensors, the plain version on
    CPU tensors.  q_bytes (B, n) / t_bytes (B, m) uint8, lengths (B,) int32,
    q_len <= n and t_len <= m."""
    if q_bytes.device.type == "cpu":
        return align_scores_plain(q_bytes, q_lens, t_bytes, t_lens, mode,
                                  match, mismatch, gap)
    _check_pair("align_scores", q_bytes, q_lens, t_bytes, t_lens)
    B, n = q_bytes.shape
    m = t_bytes.shape[1]
    out = torch.empty((3, B), dtype=torch.int32, device=q_bytes.device)
    if B:
        use_smem = 12 * (n + 1) <= build.SMEM_LIMIT
        scratch = (None if use_smem else torch.empty(
            (B, 3, n + 1), dtype=torch.int32, device=q_bytes.device))
        build.launch(
            align_scores, "bioinfo1_full_score",
            q_bytes.data_ptr(), n, t_bytes.data_ptr(), m,
            q_lens.data_ptr(), t_lens.data_ptr(), B, mode, match, mismatch,
            gap, 0 if scratch is None else scratch.data_ptr(),
            out.data_ptr(), int(use_smem),
            torch.cuda.current_stream(q_bytes.device).cuda_stream)
    return AlignOut(*out.unbind(0))


align_scores.launches = 0
