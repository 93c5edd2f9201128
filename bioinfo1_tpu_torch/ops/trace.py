"""Traceback walk over the banded parents (port of bioinfo1_tpu/ops/trace.py).

The walk starts at each read's goal cell and follows the 2-bit parents that
``ops/band.align_scores_banded(want_parents=True)`` left on the device, in
the semantics of the JAX package's lockstep walk ``trace.walk_parents``
(which mirrors the reference, team_alignment.cpp:122-161/201-238/286-335):

  * global / semiGlobal: walk to (0, 0); i == 0 takes I, j == 0 takes D;
  * local: keep the running cost, starting from the score, and stop at 0
    (a gap against a literal '-' costs 0, team_alignment.cpp:25-28);
  * op codes 0 = M, 1 = I, 2 = D; 3 = done.

Output: step-indexed codes in goal -> origin order, packed 4 per byte (step
s at row s >> 2, bit 2 * (s & 3)), shape (S4 + 1, B) for parents of S4
byte rows: the layout and shape of ``pack_codes(walk_parents(...))`` in the
JAX package.  The host only run-length encodes them
(``bioinfo1_tpu.native.cigar_rle_batch``; ``utils.cigar.cigar_from_codes``
on ``unpack_codes`` is its spec).

``walk_parents`` is the wrapper of kernel K5 (csrc/walk_parents.cu), which
serves all three modes: CUDA tensors launch the kernel, CPU tensors take
``walk_parents_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from bioinfo1_tpu_torch.kernels import build

OP_M, OP_I, OP_D, OP_DONE = 0, 1, 2, 255
_DASH = 45            # ord('-')


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Pack (S, B) op codes 4 per byte: done (255) maps to 3, rows pad with
    3 to a multiple of 4.  Inverse: ``unpack_codes``."""
    S, B = codes.shape
    s_pad = -(-S // 4) * 4
    c = torch.full((s_pad, B), 3, dtype=torch.int64, device=codes.device)
    c[:S] = codes.long().clamp(max=3)
    shifts = (2 * torch.arange(4, device=codes.device))[None, :, None]
    return (c.reshape(s_pad // 4, 4, B) << shifts).sum(dim=1).to(torch.uint8)


def unpack_codes(packed) -> np.ndarray:
    """Host inverse of ``pack_codes``: (S4, B) uint8 -> (4 * S4, B) op
    codes, 3 mapped back to done (255)."""
    p = np.asarray(packed)
    s4, B = p.shape
    out = np.empty((s4, 4, B), np.uint8)
    for k in range(4):
        out[:, k, :] = (p >> (2 * k)) & 3
    out = out.reshape(4 * s4, B)
    return np.where(out == 3, np.uint8(OP_DONE), out)


def walk_parents_plain(parents: torch.Tensor, goal_i: torch.Tensor,
                       goal_j: torch.Tensor, score: torch.Tensor,
                       q_bytes: torch.Tensor, t_bytes: torch.Tensor,
                       match: int, mismatch: int, gap: int,
                       mode: int) -> torch.Tensor:
    """Plain PyTorch lockstep walk: one step of every read per Python
    iteration, the parent byte gathered by index (clipped as the JAX
    gather clips).  Returns the packed codes, (S4 + 1, B) uint8."""
    S4, B, W = parents.shape
    dev = parents.device
    rows = torch.arange(B, device=dev)
    flat = parents.reshape(-1)
    qn, tm = q_bytes.shape[1], t_bytes.shape[1]
    i, j = goal_i.long(), goal_j.long()
    cost = score.long()
    steps = 4 * (S4 + 1)
    codes = torch.full((steps, B), 3, dtype=torch.uint8, device=dev)
    for s in range(steps):
        active = cost > 0 if mode == 1 else (i > 0) | (j > 0)
        # An inactive read stays inactive: stop once none is left.
        if s % 16 == 0 and not bool(active.any()):
            break
        d = i + j
        r = (d - 2).clamp(0, 4 * S4 - 1) >> 2
        lane = ((j - i + W - (d & 1)) >> 1).clamp(0, W - 1)
        word = flat[(r * B + rows) * W + lane].long()
        p = (word >> (2 * ((d - 2) & 3))) & 3
        if mode == 1:
            qc = q_bytes[rows, (i - 1).clamp(0, qn - 1)]
            tc = t_bytes[rows, (j - 1).clamp(0, tm - 1)]
            edge = torch.where(
                p == OP_M, torch.where(qc == tc, match, mismatch),
                torch.where(p == OP_I, torch.where(tc == _DASH, 0, gap),
                            torch.where(qc == _DASH, 0, gap)))
            cost = torch.where(active, cost - edge, cost)
        else:
            p = torch.where(i == 0, OP_I, torch.where(j == 0, OP_D, p))
        codes[s] = torch.where(active, p, 3).to(torch.uint8)
        i = torch.where(active & ((p == OP_M) | (p == OP_D)), i - 1, i)
        j = torch.where(active & ((p == OP_M) | (p == OP_I)), j - 1, j)
    return pack_codes(codes)


def walk_parents(parents: torch.Tensor, goal_i: torch.Tensor,
                 goal_j: torch.Tensor, score: torch.Tensor,
                 q_bytes: torch.Tensor, t_bytes: torch.Tensor,
                 match: int, mismatch: int, gap: int,
                 mode: int) -> torch.Tensor:
    """Packed op codes (S4 + 1, B) uint8, goal -> origin: kernel K5 on CUDA
    tensors, the plain version on CPU tensors.

    parents: (S4, B, W) uint8, the banded layout (band width W =
    parents.shape[2]); goal_i / goal_j / score: (B,) int32 (score is local
    mode's stop counter); q_bytes / t_bytes: (B, n) / (B, m) uint8 region
    bytes (local mode's edge costs)."""
    if parents.device.type == "cpu":
        return walk_parents_plain(parents, goal_i, goal_j, score, q_bytes,
                                  t_bytes, match, mismatch, gap, mode)
    if parents.dim() != 3:
        raise ValueError("walk_parents: parents must be (S4, B, W)")
    S4, B, W = parents.shape
    for name, x, dtype, ndim in (("parents", parents, torch.uint8, 3),
                                 ("goal_i", goal_i, torch.int32, 1),
                                 ("goal_j", goal_j, torch.int32, 1),
                                 ("score", score, torch.int32, 1),
                                 ("q_bytes", q_bytes, torch.uint8, 2),
                                 ("t_bytes", t_bytes, torch.uint8, 2)):
        rows = x.shape[1] if name == "parents" else x.shape[0]
        if (x.dtype != dtype or x.dim() != ndim or rows != B
                or not x.is_contiguous() or x.device != parents.device):
            raise ValueError(f"walk_parents: {name} must be a contiguous "
                             f"{dtype} {ndim}-D tensor with {B} reads on "
                             f"{parents.device}")
    if S4 < 1 or q_bytes.shape[1] < 1 or t_bytes.shape[1] < 1:
        raise ValueError("walk_parents: empty parents, query or target")
    out = torch.full((S4 + 1, B), 0xFF, dtype=torch.uint8,
                     device=parents.device)
    if B:
        build.launch(
            walk_parents, "bioinfo1_walk_parents", parents.data_ptr(), S4, B,
            W, goal_i.data_ptr(), goal_j.data_ptr(), score.data_ptr(),
            q_bytes.data_ptr(), q_bytes.shape[1], t_bytes.data_ptr(),
            t_bytes.shape[1], mode, match, mismatch, gap, out.data_ptr(),
            torch.cuda.current_stream(parents.device).cuda_stream)
    return out


walk_parents.launches = 0
