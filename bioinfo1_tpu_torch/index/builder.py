"""Minimizer index of the reference genome as sorted arrays.

TPU-first replacement for the reference's
``unordered_map<hash, set<pair<pos,bool>>>`` (team_mapper.cpp:412-413):
a hash map is hostile to fixed-shape device code, so the index is two sorted
arrays per strand - (hash, pos) pairs sorted lexicographically - and lookups
become ``searchsorted`` + contiguous gathers (see ops/match.py).

Build semantics (team_mapper.cpp:410-477, quirks 3-5 in SURVEY.md 2.3):
  * forward strand indexes the reference, reverse strand indexes the
    re-minimized reverse complement (positions live in RC coordinates),
  * per-strand frequency = number of windows a hash won (duplicates count),
  * the top ``int(f * |unique (hash,pos,strand) tuples|)`` hashes by window
    count are banned; tie order is deterministic here (count desc, hash asc),
  * the banned_rev-from-fwd copy-paste bug (team_mapper.cpp:469) is NOT
    replicated (fixed; ``banned_rev_from_fwd=True`` restores it for parity
    testing against the reference binary).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class StrandIndexArrays:
    """Sorted-array index for one strand.

    hash_sorted / pos_sorted: (U,) uint32/int32, lexicographically sorted by
    (hash, pos); positions are 1-based, unique per hash (the C++ set dedup).
    """

    hash_sorted: np.ndarray
    pos_sorted: np.ndarray
    n_unique_tuples: int          # |unique (hash,pos)| BEFORE banning
    n_distinct_hashes: int        # distinct hashes BEFORE banning
    n_singleton_hashes: int       # hashes with window-frequency == 1
    banned: np.ndarray            # (Nb,) uint32 banned hashes
    max_bucket: int               # largest surviving per-hash position count
    top_surviving: Optional[Tuple[int, int]]  # (hash, window count) or None


@dataclasses.dataclass
class IndexArrays:
    fwd: StrandIndexArrays
    rev: StrandIndexArrays
    ref_len: int
    k: int
    w: int
    # Strand sequences cached for alignment-region extraction (filled by the
    # pipeline layer; not persisted by save_index - reload re-derives them).
    ref_fwd_seq: Optional[str] = None
    ref_rev_seq: Optional[str] = None


_BASE_CODE = np.zeros(256, dtype=np.uint32)
for _c, _v in zip(b"CATG", (0, 1, 2, 3)):
    _BASE_CODE[_c] = _v

# Byte-level complement table (team_mapper.cpp:49-63 switch): A<->T, G<->C,
# every other byte passes through unchanged.
_COMP_BYTES = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ATGC", b"TACG"):
    _COMP_BYTES[_a] = _b


def reverse_complement_bytes(seq_bytes: np.ndarray) -> np.ndarray:
    """Vectorized ReverseComplement (team_mapper.cpp:49-63): reverse, then
    complement A<->T / G<->C, non-ACGT bytes unchanged.  Semantics identical
    to reference_model.reverse_complement, ~1000x faster on genome-scale
    strings (one table gather instead of a per-char Python join)."""
    return _COMP_BYTES[seq_bytes[::-1]]


def reverse_complement_str(seq: str) -> str:
    """String-in/string-out wrapper over reverse_complement_bytes."""
    b = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)
    return reverse_complement_bytes(b).tobytes().decode("latin1")


def _host_kmer_hashes(seq_bytes: np.ndarray, k: int) -> np.ndarray:
    """Rolling 2-bit hashes on the host: serves both the full-genome dense
    sweep (_strand_sweep) and the tiny end-windows."""
    nk = len(seq_bytes) - k + 1
    if nk <= 0:
        return np.zeros((0,), dtype=np.uint32)
    codes = _BASE_CODE[seq_bytes]
    h = np.zeros((nk,), dtype=np.uint32)
    for j in range(k):
        h = (h << np.uint32(2)) | codes[j:j + nk]
    return h


def _strand_sweep(seq_bytes: np.ndarray, k: int, w: int,
                  oob_end_windows: bool = False):
    """All window-win (hash, 1-based pos) pairs of one genome strand,
    duplicates included (order is irrelevant - the index sorts).

    Dense windows are a vectorized host sweep (see inline note); the
    <= 2(w-1) end-windows (team_minimizers.cpp:146-170, 197-222) too.
    """
    L = len(seq_bytes)
    nk = L - k + 1
    if nk <= 0:
        z = np.zeros((0,), dtype=np.uint32)
        return z, z.astype(np.int32)

    pre_h: list = []
    pre_p: list = []
    suf_h: list = []
    suf_p: list = []

    # End-windows (fixed semantics: prefix clamps to valid k-mers instead of
    # the reference's out-of-bounds read; suffix guarded by L >= k + s - 1).
    if w > 1:
        head_bytes = seq_bytes[: (w - 1) + k - 1]
        if oob_end_windows and len(head_bytes) < (w - 1) + k - 1:
            # Reference bug #4: unguarded prefix windows read past the end;
            # zero bytes stand in for the c_str NUL (+ best-effort beyond).
            head_bytes = np.concatenate([
                head_bytes,
                np.zeros((w - 1) + k - 1 - len(head_bytes), dtype=np.uint8)])
        head = _host_kmer_hashes(head_bytes, k)
        tail_start = max(nk - (w - 1), 0)
        tail = _host_kmer_hashes(seq_bytes[tail_start:], k)
        for s in range(1, w):
            hi = s if oob_end_windows else min(s, len(head))
            if hi > 0:
                j = int(np.argmin(head[:hi]))
                pre_h.append(np.uint32(head[j])); pre_p.append(np.int32(j + 1))
            if nk >= s:
                window = tail[len(tail) - s:]
                j = int(np.argmin(window))
                suf_p.append(np.int32(nk - s + j + 1))
                suf_h.append(np.uint32(window[j]))

    nd = nk - w + 1
    if nd > 0:
        # Dense windows, vectorized on the host.  The genome sweep happens
        # ONCE per index build, so a device launch buys nothing and costs a
        # ~67 MB/strand round-trip (which dominated index build over the
        # remote-TPU link: 174 s -> <0.2 s with this path).  The per-READ
        # sweep stays on device (ops/minimizer.py) where it amortizes into
        # the fused mapping step.  Semantics identical to the reference's
        # GetTupleWithMinFirst strict '<' left scan (team_minimizers.cpp:
        # 106-120): leftmost window minimum.
        kh = _host_kmer_hashes(seq_bytes, k)          # (nk,) uint32
        th = kh[:nd].copy()
        off = np.zeros(nd, dtype=np.int32)
        for j in range(1, w):
            cand = kh[j:j + nd]
            upd = cand < th
            th[upd] = cand[upd]
            off[upd] = j
        tp = np.arange(nd, dtype=np.int32) + off + 1  # 1-based positions
    else:
        th = np.zeros((0,), dtype=np.uint32)
        tp = np.zeros((0,), dtype=np.int32)

    # Reference EMIT order - prefix windows, dense windows, suffix windows
    # (team_minimizers.cpp:146-222).  Load-bearing only for the bug-compat
    # banned set, whose unordered_map iteration order depends on insertion
    # order; the index itself sorts.
    return (np.concatenate([np.array(pre_h, dtype=np.uint32), th,
                            np.array(suf_h, dtype=np.uint32)]),
            np.concatenate([np.array(pre_p, dtype=np.int32), tp,
                            np.array(suf_p, dtype=np.int32)]))


def _build_strand(hashes: np.ndarray, pos: np.ndarray, f: float,
                  ban_order: Optional[np.ndarray] = None,
                  ban_count_limit: Optional[int] = None,
                  unique_override: Optional[int] = None,
                  exact_orders=None) -> StrandIndexArrays:
    """Sort, dedup, count window wins, ban top-f, and pack one strand.

    ``hashes``/``pos`` are the strand's window-win stream in the reference's
    EMIT order (duplicates included).  Banning takes the top
    ``min(int(f * unique), limit)`` hashes of a count-descending ranking:

      * fixed semantics (default): deterministic (count desc, hash asc),
      * ``exact_orders`` = this strand's (iter_hash, iter_count, sorted_hash)
        from native.freq_orders2: the libstdc++ unordered_map iteration +
        unstable std::sort orders - the only way to reproduce the
        reference's tie choices byte-for-byte,
      * ``ban_order`` overrides the ranking entirely (reference bug #1 draws
        the rev banned set from the FWD ranking, team_mapper.cpp:469).
    """
    order = np.lexsort((pos, hashes))
    hs, ps = hashes[order], pos[order]
    # Unique (hash, pos) tuples = C++ unique_minmizers set (strand constant).
    new_tuple = np.ones(len(hs), dtype=bool)
    if len(hs) > 1:
        new_tuple[1:] = (hs[1:] != hs[:-1]) | (ps[1:] != ps[:-1])
    uh, up = hs[new_tuple], ps[new_tuple]
    n_unique = len(uh)

    # Window-win frequency per distinct hash (duplicates included): run
    # lengths of the already-sorted hs stream (== np.unique(hashes,
    # return_counts=True) without paying a second full sort).
    if len(hs):
        run_start = np.ones(len(hs), dtype=bool)
        run_start[1:] = hs[1:] != hs[:-1]
        starts_i = np.flatnonzero(run_start)
        distinct = hs[starts_i]
        freq = np.diff(np.append(starts_i, len(hs)))
    else:
        distinct = hs
        freq = np.zeros((0,), dtype=np.int64)
    n_distinct = len(distinct)
    n_singleton = int((freq == 1).sum())

    iter_hash = iter_count = None
    if exact_orders is not None:
        iter_hash, iter_count, rank_order = exact_orders

    threshold = int(f * (n_unique if unique_override is None else unique_override))
    if ban_order is not None:
        rank_order = ban_order
    elif exact_orders is None:
        rank = np.lexsort((distinct, -freq.astype(np.int64)))
        rank_order = distinct[rank]
    limit = n_distinct if ban_count_limit is None else ban_count_limit
    count = max(0, min(threshold, limit))
    banned = np.sort(rank_order[:count].astype(np.uint32))

    keep = ~np.isin(uh, banned, assume_unique=False)
    fh, fp = uh[keep].astype(np.uint32), up[keep].astype(np.int32)

    max_bucket = 0
    if len(fh):
        _, bucket_counts = np.unique(fh, return_counts=True)
        max_bucket = int(bucket_counts.max())

    # Most frequent surviving minimizer (team_mapper.cpp:504-520 statistics):
    # a strict '>' scan of the histogram, so ties go to the FIRST hash in
    # map iteration order (exact_ties) or to the smallest hash (fixed).
    top = None
    if iter_hash is not None:
        scan_h, scan_c = iter_hash, iter_count
    else:
        o = np.argsort(distinct)
        scan_h, scan_c = distinct[o], freq[o]
    surviving = ~np.isin(scan_h, banned)
    if surviving.any():
        sfreq = np.where(surviving, scan_c, np.iinfo(np.int64).min)
        i = int(np.argmax(sfreq))  # first strictly-greater max in scan order
        top = (int(scan_h[i]), int(scan_c[i]))

    return StrandIndexArrays(
        hash_sorted=fh, pos_sorted=fp, n_unique_tuples=n_unique,
        n_distinct_hashes=n_distinct, n_singleton_hashes=n_singleton,
        banned=banned, max_bucket=max_bucket, top_surviving=top)


def build_index(reference: str, k: int, w: int, f: float,
                banned_rev_from_fwd: bool = False,
                threshold_from_rev_unique: bool = False,
                exact_ties: bool = False,
                oob_end_windows: bool = False) -> IndexArrays:
    """``threshold_from_rev_unique`` replicates the shared-global quirk where
    both strands' ban thresholds scale with the REV unique-tuple count (see
    reference_model.build_index docstring; team_mapper.cpp:433-434 +
    team_minimizers.cpp:19-22).  ``exact_ties`` reproduces the reference's
    unordered_map/std::sort tie choices via the native helper."""
    ref_bytes = np.frombuffer(reference.encode("latin1"), dtype=np.uint8)
    fwd_h, fwd_p = _strand_sweep(ref_bytes, k, w, oob_end_windows)
    rc_bytes = reverse_complement_bytes(ref_bytes)
    rc = rc_bytes.tobytes().decode("latin1")
    rev_h, rev_p = _strand_sweep(rc_bytes, k, w, oob_end_windows)

    unique_override = None
    if threshold_from_rev_unique:
        ro = np.lexsort((rev_p, rev_h))
        rh2, rp2 = rev_h[ro], rev_p[ro]
        new_t = np.ones(len(rh2), dtype=bool)
        if len(rh2) > 1:
            new_t[1:] = (rh2[1:] != rh2[:-1]) | (rp2[1:] != rp2[:-1])
        unique_override = int(new_t.sum())

    fwd_orders = rev_orders = None
    if exact_ties:
        from bioinfo1_tpu_torch import native
        res = native.freq_orders2(fwd_h, rev_h)
        if res is not None:
            fwd_orders, rev_orders = res

    fwd = _build_strand(fwd_h, fwd_p, f, unique_override=unique_override,
                        exact_orders=fwd_orders)
    if banned_rev_from_fwd:
        # Reference bug #1: rev banned hashes drawn from the fwd ranking,
        # loop bound still min(threshold_rev, |rev distinct|).
        if fwd_orders is not None:
            fwd_rank = fwd_orders[2]
        else:
            fwd_distinct, fwd_freq = np.unique(fwd_h, return_counts=True)
            rank = np.lexsort((fwd_distinct, -fwd_freq.astype(np.int64)))
            fwd_rank = fwd_distinct[rank]
        rev_distinct_count = len(np.unique(rev_h))
        rev = _build_strand(rev_h, rev_p, f,
                            ban_order=fwd_rank,
                            ban_count_limit=rev_distinct_count,
                            exact_orders=rev_orders)
    else:
        rev = _build_strand(rev_h, rev_p, f, exact_orders=rev_orders)

    return IndexArrays(fwd=fwd, rev=rev, ref_len=len(reference), k=k, w=w,
                       ref_fwd_seq=reference, ref_rev_seq=rc)


def save_index(index: IndexArrays, path: str) -> None:
    """Persist the packed index (checkpoint/resume subsystem; the reference
    rebuilds from FASTA every run - SURVEY.md section 5).

    Contract: the strand SEQUENCES (ref_fwd_seq/ref_rev_seq) are NOT
    persisted - only the packed minimizer arrays and statistics.  A loader
    must re-derive them from the reference FASTA (which the CLI always has
    in hand: pipeline/mapper.Mapper.__init__ re-attaches both strands after
    load_index).  This keeps index artifacts small (arrays compress well;
    genomes are re-read in milliseconds) and guarantees the sequences can
    never drift from the FASTA they came from."""
    def top_arr(top):
        # (-1, -1) encodes "no surviving minimizer" (top_surviving=None).
        return np.array(top if top is not None else (-1, -1), dtype=np.int64)

    np.savez_compressed(
        path,
        fwd_hash=index.fwd.hash_sorted, fwd_pos=index.fwd.pos_sorted,
        rev_hash=index.rev.hash_sorted, rev_pos=index.rev.pos_sorted,
        fwd_banned=index.fwd.banned, rev_banned=index.rev.banned,
        fwd_top=top_arr(index.fwd.top_surviving),
        rev_top=top_arr(index.rev.top_surviving),
        meta=np.array([index.ref_len, index.k, index.w,
                       index.fwd.n_unique_tuples, index.rev.n_unique_tuples,
                       index.fwd.n_distinct_hashes, index.rev.n_distinct_hashes,
                       index.fwd.n_singleton_hashes, index.rev.n_singleton_hashes,
                       index.fwd.max_bucket, index.rev.max_bucket],
                      dtype=np.int64))


def load_index(path: str) -> IndexArrays:
    z = np.load(path)
    meta = z["meta"]

    def strand(prefix, ui, di, si, mi):
        top = None
        if f"{prefix}_top" in z.files:  # older files lack it -> None
            t = z[f"{prefix}_top"]
            if t[0] >= 0:
                top = (int(t[0]), int(t[1]))
        return StrandIndexArrays(
            hash_sorted=z[f"{prefix}_hash"], pos_sorted=z[f"{prefix}_pos"],
            n_unique_tuples=int(meta[ui]), n_distinct_hashes=int(meta[di]),
            n_singleton_hashes=int(meta[si]), banned=z[f"{prefix}_banned"],
            max_bucket=int(meta[mi]), top_surviving=top)

    return IndexArrays(
        fwd=strand("fwd", 3, 5, 7, 9), rev=strand("rev", 4, 6, 8, 10),
        ref_len=int(meta[0]), k=int(meta[1]), w=int(meta[2]))
