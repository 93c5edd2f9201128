"""Host-side traceback from packed parent diagonals + CIGAR compression.

The device wavefront (ops/align.py, ops/pallas_align.py) emits 2-bit parents
packed 16-per-uint32 along anti-diagonals; this module walks them back into
op strings.  Walking is O(path length) per read and only runs under the -c
flag, so host cost is negligible next to the device fill.

CIGAR convention matches the reference (team_alignment.cpp:128-137): ``I``
consumes the target, ``D`` consumes the query - the opposite of SAM.  Pass
``sam_convention=True`` to emit standard SAM CIGARs instead (documented
extension; the reference offers no such switch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_M, _I, _D = 0, 1, 2


def _parent(parents: np.ndarray, i: int, j: int, band: int = 0) -> int:
    """Parent code of interior cell (i, j); diag d=i+j stored at row d-2.

    With ``band`` set, parents are in band coordinates (align_banded_parents):
    lane l of diagonal d holds offset o = j - i = 2l - band + (d & 1).
    """
    d = i + j
    if band:
        lane = (j - i + band - (d & 1)) >> 1
    else:
        lane = i
    if parents.dtype == np.uint8:
        # Pallas banded layout: 4 steps per byte, step idx = d-2 at row
        # idx>>2 bit 2*(idx&3) (ops/pallas_band.py).
        word = parents[(d - 2) >> 2, lane]
        return (int(word) >> (2 * ((d - 2) & 3))) & 3
    word = parents[d - 2, lane >> 4]
    return (int(word) >> (2 * (lane & 15))) & 3


def compress(ops: str, sam_convention: bool = False) -> str:
    if not ops:
        return ""
    if sam_convention:
        ops = ops.translate(str.maketrans("ID", "DI"))
    out = []
    prev, count = ops[0], 1
    for c in ops[1:]:
        if c == prev:
            count += 1
        else:
            out.append(f"{count}{prev}")
            prev, count = c, 1
    out.append(f"{count}{prev}")
    return "".join(out)


def cigar_from_codes(codes: np.ndarray, mode: str, goal_i: int, goal_j: int,
                     n: int, m: int, sam_convention: bool = False,
                     local_target_begin_end: bool = False,
                     ) -> Tuple[str, Optional[int]]:
    """Decode one read's device-walk op codes (ops/trace.py) into a CIGAR.

    ``codes`` is (steps,) uint8 in goal->origin order.  255 entries are
    SKIPPED, not terminal: the lockstep XLA walk (ops/trace.walk_parents)
    emits them only as trailing padding, while the Pallas per-diagonal walk
    (walk_parents_pallas) interleaves them mid-stream (a match step jumps
    two diagonals, and reads idle until the sweep reaches their goal
    diagonal) - both decode identically under skip semantics.  Run-length
    encoding is vectorized numpy - the host does no per-base Python loop
    (the device walk replaced it).
    """
    ops = codes[codes != 255][::-1]               # origin -> goal order
    if mode == "local":
        consumed_j = int(np.count_nonzero(ops != 2))   # M or I move j
        target_begin = (goal_j + 1 if local_target_begin_end
                        else goal_j - consumed_j)
    else:
        target_begin = 0
    if mode == "semiGlobal" and (goal_j != m or goal_i != n):
        # Pad to the corner (team_alignment.cpp:306-315).
        if goal_i == n:
            ops = np.concatenate([ops, np.full(m - goal_j, 1, np.uint8)])
        elif goal_j == m:
            ops = np.concatenate([ops, np.full(n - goal_i, 2, np.uint8)])
    if len(ops) == 0:
        return "", target_begin
    letters = np.array(["M", "D", "I"] if sam_convention else ["M", "I", "D"])
    bounds = np.flatnonzero(ops[1:] != ops[:-1])
    starts = np.concatenate([[0], bounds + 1])
    ends = np.concatenate([bounds + 1, [len(ops)]])
    parts = [f"{e - s}{letters[ops[s]]}" for s, e in zip(starts, ends)]
    return "".join(parts), target_begin


def traceback(parents: np.ndarray, query: str, target: str,
              goal_i: int, goal_j: int, mode: str, score: int,
              match: int, mismatch: int, gap: int,
              sam_convention: bool = False,
              local_target_begin_end: bool = False,
              band: int = 0,
              ) -> Tuple[str, Optional[int]]:
    """Walk parents from the goal cell; returns (cigar, target_begin).

    ``parents`` is the (steps, W) uint32 slice for ONE read (diag-major).
    For local mode the walk maintains the running cost H[parent] =
    H[cell] - edge (exact, see reference_model docstring) and stops at 0;
    for global/semiGlobal it walks to (0, 0) with boundary rules i==0 -> I,
    j==0 -> D (the reference's init parents, team_alignment.cpp:83-92).
    ``band``: the parents are band-coordinate (align_banded_parents); only
    valid for reads that pass certify(..., strict=True).
    """
    n, m = len(query), len(target)
    i, j = goal_i, goal_j
    ops_rev = []

    def edge_cost(p: int, i: int, j: int) -> int:
        if p == _M:
            return match if query[i - 1] == target[j - 1] else mismatch
        if p == _I:
            return 0 if target[j - 1] == "-" else gap
        return 0 if query[i - 1] == "-" else gap

    if mode == "local":
        cost = score
        while cost > 0:
            p = _parent(parents, i, j, band)
            cost -= edge_cost(p, i, j)
            if p == _M:
                ops_rev.append("M"); i -= 1; j -= 1
            elif p == _I:
                ops_rev.append("I"); j -= 1
            else:
                ops_rev.append("D"); i -= 1
        target_begin = goal_j + 1 if local_target_begin_end else j
    else:
        while i > 0 or j > 0:
            p = _I if i == 0 else (_D if j == 0
                                   else _parent(parents, i, j, band))
            if i > 0 and j > 0 and p == _M:
                ops_rev.append("M"); i -= 1; j -= 1
            elif j > 0 and p == _I:
                ops_rev.append("I"); j -= 1
            elif i > 0 and p == _D:
                ops_rev.append("D"); i -= 1
            else:  # pragma: no cover
                raise ValueError("Unknown error in determining cigar string.")
        target_begin = 0

    ops = "".join(reversed(ops_rev))
    if mode == "semiGlobal" and (goal_j != m or goal_i != n):
        # Pad to the corner (team_alignment.cpp:306-315).
        if goal_i == n:
            ops += "I" * (m - goal_j)
        elif goal_j == m:
            ops += "D" * (n - goal_i)
    return compress(ops, sam_convention=sam_convention), target_begin
