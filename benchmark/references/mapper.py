"""Plain reference of the mapper's semantics, for judging its PAF rows.

A straightforward implementation of what the reference C++ mapper
(AnamarijaKic/bioinfo1, team_mapper.cpp / team_minimizers.cpp /
team_alignment.cpp) computes at its fixed semantics, written from that
specification alone: numpy on the host and plain PyTorch for the DP, no
kernel, no cache, nothing of the program.

* k-mer hash: 2 bits a base, C=0 < A=1 < T=2 < G=3 (any other byte 0),
  most significant first.
* Minimizers: the leftmost smallest hash of every window of w k-mers, the
  prefix end-windows of 1..w-1 k-mers first and the suffix end-windows of
  1..w-1 k-mers last; 1-based positions.  A read's list drops repeated
  (hash, position) tuples, keeping the first.
* Index, per strand (the genome, and its reverse complement re-minimized):
  every window's winner counts once for its hash; the top
  int(f * |distinct (hash, position)|) hashes by that count (ties: smaller
  hash first) are banned; each other hash maps to its positions, ascending.
* Matches, per strand: for each read minimizer in order, the strand's
  positions of its hash, ascending.
* Chain: O(n^2) LIS in match order; j precedes i when r_j < r_i < r_j + 5000
  and f_j < f_i < f_j + 5000; lis improves only strictly (the first best j),
  the chain ends at the first longest.  The forward chain wins ties.
* Region: query [f_first - 1, f_last + k - 2], target the same on the
  chosen strand; a global DP (linear gaps, a literal '-' costs 0 inside the
  matrix), and under -c the traceback with M > I > D (I consumes the target,
  D the query), run-length encoded.
* PAF: name, length, query start and end, strand, reference name and
  length, target start and end (forward coordinates), the DP score, the
  query span, 60, and under -c ``cg:Z:``.

``band`` (the control, never the reference) restricts the DP to the cells
with j - i in [-band, band - 1]: the banded score taken as final without a
certificate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CHAIN_GAP = 5000
_CODE = np.zeros(256, np.uint32)
for _c, _v in zip(b"CATG", (0, 1, 2, 3)):
    _CODE[_c] = _v
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ATGC", b"TACG"):
    _COMP[_a] = _b
_NEG = -(2 ** 30)
_DASH = ord("-")


def kmer_hashes(seq: np.ndarray, k: int) -> np.ndarray:
    nk = len(seq) - k + 1
    if nk <= 0:
        return np.zeros(0, np.uint32)
    codes = _CODE[seq]
    h = np.zeros(nk, np.uint32)
    for j in range(k):
        h = (h << np.uint32(2)) | codes[j:j + nk]
    return h


def window_winners(seq: np.ndarray, k: int, w: int) -> Tuple[np.ndarray,
                                                              np.ndarray]:
    """(hash, 1-based position) of every window's winner in emit order:
    prefix end-windows, full windows, suffix end-windows."""
    kh = kmer_hashes(seq, k)
    nk = len(kh)
    if nk == 0 or w == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int64)
    idx: List[np.ndarray] = []
    # Prefix end-windows: the first s k-mers, s = 1..w-1 (clamped to nk).
    pre = [int(np.argmin(kh[:min(s, nk)])) for s in range(1, w)]
    idx.append(np.array(pre, np.int64))
    if nk >= w:
        full = np.lib.stride_tricks.sliding_window_view(kh, w)
        idx.append(np.argmin(full, axis=1).astype(np.int64)
                   + np.arange(nk - w + 1))
    # Suffix end-windows: the last s k-mers, s = 1..w-1, while they fit.
    L = len(seq)
    suf = [nk - s + int(np.argmin(kh[nk - s:])) for s in range(1, w)
           if L >= k + s - 1 and s <= nk]
    idx.append(np.array(suf, np.int64))
    at = np.concatenate(idx)
    return kh[at], at + 1


class StrandIndex:
    """One strand's index: sorted unique (hash, position) rows without the
    banned hashes."""

    def __init__(self, seq: np.ndarray, k: int, w: int, f: float) -> None:
        h, p = window_winners(seq, k, w)
        hashes, counts = np.unique(h, return_counts=True)
        tuples = np.unique(h.astype(np.int64) << 32 | p)
        n_ban = max(0, min(int(f * len(tuples)), len(hashes)))
        order = np.lexsort((hashes, -counts))
        banned = hashes[order[:n_ban]]
        th = (tuples >> 32).astype(np.uint32)
        keep = ~np.isin(th, banned)
        self.hash = th[keep]
        self.pos = (tuples[keep] & 0xFFFFFFFF).astype(np.int64)

    def lookup(self, hashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(i, pos): for the i-th query hash, each of its positions."""
        lo = np.searchsorted(self.hash, hashes, side="left")
        hi = np.searchsorted(self.hash, hashes, side="right")
        n = hi - lo
        i = np.repeat(np.arange(len(hashes)), n)
        first = np.repeat(lo - (np.cumsum(n) - n), n)
        return i, self.pos[first + np.arange(int(n.sum()))]


class Reference:
    """The reference mapper over one genome."""

    def __init__(self, name: str, genome: np.ndarray, k: int, w: int,
                 f: float) -> None:
        self.name = name
        self.fwd_seq = genome
        self.rev_seq = _COMP[genome[::-1]]
        self.k, self.w = k, w
        self.fwd = StrandIndex(self.fwd_seq, k, w, f)
        self.rev = StrandIndex(self.rev_seq, k, w, f)

    def read_minimizers(self, read: np.ndarray) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        h, p = window_winners(read, self.k, self.w)
        key = h.astype(np.int64) << 32 | p
        _, first = np.unique(key, return_index=True)
        first = np.sort(first)
        return h[first], p[first]

    def chain(self, read: np.ndarray) -> Optional[tuple]:
        """(is_fwd, q_begin, q_end, t_begin, t_end) with inclusive 0-based
        ends in strand coordinates, or None when neither strand chains."""
        h, p = self.read_minimizers(read)
        best = None
        for fwd, index in ((True, self.fwd), (False, self.rev)):
            i, r = index.lookup(h)
            c = lis_chain(p[i], r)
            if best is None or len(c) > len(best[1]):
                best = (fwd, c)
        fwd, c = best
        if not len(c):
            return None
        k = self.k
        return (fwd, int(c[0][0]) - 1, int(c[-1][0]) + k - 2,
                int(c[0][1]) - 1, int(c[-1][1]) + k - 2)


def lis_chain(f: np.ndarray, r: np.ndarray) -> List[Tuple[int, int]]:
    """The longest chain in match order (see the module docstring)."""
    n = len(f)
    if n == 0:
        return []
    f = f.astype(np.int64)
    r = r.astype(np.int64)
    lis = np.ones(n, np.int64)
    prev = np.full(n, -1, np.int64)
    for i in range(1, n):
        ok = ((r[:i] < r[i]) & (r[i] - r[:i] < CHAIN_GAP)
              & (f[:i] < f[i]) & (f[i] - f[:i] < CHAIN_GAP))
        if ok.any():
            cand = np.where(ok, lis[:i], 0)
            j = int(np.argmax(cand))
            lis[i] = cand[j] + 1
            prev[i] = j
    i = int(np.argmax(lis))
    out = []
    while i >= 0:
        out.append((int(f[i]), int(r[i])))
        i = int(prev[i])
    return out[::-1]


def global_dp(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], match: int,
              mismatch: int, gap: int, want_cigar: bool,
              device: torch.device, band: int = 0,
              ) -> List[Tuple[int, Optional[str]]]:
    """(score, CIGAR or None) of each (query, target) pair's global
    alignment, the pairs of a call run together row by row."""
    B = len(pairs)
    N = max(len(q) for q, _ in pairs)
    M = max(len(t) for _, t in pairs)
    Q = np.zeros((B, max(N, 1)), np.uint8)
    T = np.zeros((B, max(M, 1)), np.uint8)
    for b, (q, t) in enumerate(pairs):
        Q[b, :len(q)] = q
        T[b, :len(t)] = t
    ql = torch.tensor([len(q) for q, _ in pairs], device=device)
    tl = torch.tensor([len(t) for _, t in pairs], device=device)
    Qd = torch.from_numpy(Q).to(device)
    Td = torch.from_numpy(T).to(device)[:, :M]
    i32 = torch.int32
    ins = torch.where(Td == _DASH, 0, gap).to(i32)
    gp = torch.cat([torch.zeros((B, 1), dtype=i32, device=device),
                    torch.cumsum(ins, 1, dtype=i32)], 1)
    j = torch.arange(M + 1, device=device, dtype=i32)
    H = (j * gap).expand(B, M + 1).contiguous()
    score = torch.where(ql == 0, (tl * gap).to(i32),
                        torch.zeros(B, dtype=i32, device=device))
    par = (torch.empty((N, B, M), dtype=torch.uint8, device=device)
           if want_cigar else None)
    for i in range(1, N + 1):
        qi = Qd[:, i - 1:i]
        sub = torch.where(Td == qi, match, mismatch).to(i32)
        dele = torch.where(qi == _DASH, 0, gap).to(i32)
        diag = H[:, :-1] + sub
        up = H[:, 1:] + dele
        c = torch.maximum(diag, up)
        if band:
            off = j[1:] - i
            inband = (off >= -band) & (off < band)
            c = torch.where(inband, c, _NEG)
        base = torch.cat([torch.full((B, 1), i * gap, dtype=i32,
                                     device=device), c], 1) - gp
        row = torch.cummax(base, 1).values + gp
        if band:
            row = torch.where((j - i >= -band) & (j - i < band), row, _NEG)
        if par is not None:
            best = row[:, 1:]
            left = row[:, :-1] + ins
            par[i - 1] = torch.where(diag == best, 0,
                                     torch.where(left == best, 1, 2)).to(
                                         torch.uint8)
        score = torch.where(ql == i, row.gather(1, tl[:, None].long())[:, 0],
                            score)
        H = row
    scores = score.cpu().tolist()
    if par is None:
        return [(s, None) for s in scores]
    out = []
    for b, (q, t) in enumerate(pairs):
        P = par[:len(q), b, :len(t)].cpu().numpy()
        out.append((scores[b], traceback(P, len(q), len(t))))
    return out


def traceback(P: np.ndarray, n: int, m: int) -> str:
    """The run-length CIGAR of the path from (n, m) to (0, 0); P[i - 1, j - 1]
    is cell (i, j)'s parent (0 M, 1 I, 2 D)."""
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i == 0:
            op = 1
        elif j == 0:
            op = 2
        else:
            op = int(P[i - 1, j - 1])
        ops.append(op)
        if op == 0:
            i -= 1
            j -= 1
        elif op == 1:
            j -= 1
        else:
            i -= 1
    runs = []
    for op in reversed(ops):
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    return "".join(f"{c}{'MID'[op]}" for op, c in runs)


def paf_rows(ref: Reference, reads: Dict[str, np.ndarray], match: int,
             mismatch: int, gap: int, want_cigar: bool,
             device: torch.device, block_cells: float, band: int = 0,
             ) -> Dict[str, Optional[str]]:
    """{read name: its PAF row without the name column, or None}.  Under
    -c the DPs run in blocks of pairs of similar length whose cells stay
    under ``block_cells`` (their parents live on ``device`` a block at a
    time); score-only DPs keep two rows a pair and run in one block."""
    hits = {}
    for name, read in reads.items():
        c = ref.chain(read)
        if c is None:
            continue
        fwd, qb, qe, tb, te = c
        strand = ref.fwd_seq if fwd else ref.rev_seq
        hits[name] = (c, read[qb:qe + 1], strand[tb:te + 1])
    order = sorted(hits, key=lambda n: len(hits[n][1]))
    results: Dict[str, tuple] = {}
    lo = 0
    while lo < len(order):
        hi = lo + 1
        while (hi < len(order)
               and (not want_cigar
                    or (hi + 1 - lo) * len(hits[order[hi]][1])
                    * len(hits[order[hi]][2]) <= block_cells)):
            hi += 1
        names = order[lo:hi]
        got = global_dp([hits[n][1:] for n in names], match, mismatch, gap,
                        want_cigar, device, band)
        results.update(zip(names, got))
        lo = hi
    out: Dict[str, Optional[str]] = {}
    L = len(ref.fwd_seq)
    for name, read in reads.items():
        if name not in hits:
            out[name] = None
            continue
        (fwd, qb, qe, tb, te), _, _ = hits[name]
        score, cigar = results[name]
        ts, tend = (tb, te + 1) if fwd else (L - te - 1, L - tb)
        cols = [str(len(read)), str(qb), str(qe + 1), "+" if fwd else "-",
                ref.name, str(L), str(ts), str(tend), str(score),
                str(qe - qb + 1), "60"]
        if want_cigar:
            cols.append(f"cg:Z:{cigar}")
        out[name] = "\t".join(cols)
    return out
