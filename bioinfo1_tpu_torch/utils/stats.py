"""Statistics blocks for the -s flag, byte-matching the reference output.

Covers:
* per-file basic statistics (team_mapper.cpp:186-280) - delegated to
  io.fastx.basic_statistics,
* reference-index statistics: distinct minimizer counts, singleton fractions,
  most frequent surviving minimizer (team_mapper.cpp:480-525),
* per-read statistics: distinct minimizers + singleton fraction
  (team_mapper.cpp:610-624).

C++ ``cout << double`` prints with 6 significant digits (default precision);
Python's ``%g`` matches that.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fmt_double(x: float) -> str:
    """Mirror std::cout's default double formatting (6 significant digits)."""
    s = f"{x:.6g}"
    return s


def decode_hash(h: int, k: int) -> str:
    """MappKmerBitToStringFWD (team_mapper.cpp:66-88): digits '0'-'3',
    MSB-first over the low 2k bits."""
    out = []
    for i in range(k - 1, -1, -1):
        out.append(str((h >> (2 * i)) & 3))
    return "".join(out)


def index_statistics(fwd_stats: Tuple[int, int, Optional[Tuple[int, int]]],
                     rev_stats: Tuple[int, int, Optional[Tuple[int, int]]],
                     k: int) -> str:
    """The reference-genome index stats block (team_mapper.cpp:483-524).

    Each strand tuple is (n_distinct_hashes, n_singleton_hashes,
    top_surviving) where top_surviving is (hash, window_count) or None.
    """
    (nd_f, ns_f, top_f) = fwd_stats
    (nd_r, ns_r, top_r) = rev_stats
    lines = [
        f"Number of distinct minimizers for forward strand: {nd_f}",
        f"Number of distinct minimizers for reverse complement: {nd_r}",
        f"Fraction of singletons on forward strand: "
        f"{fmt_double(ns_f / nd_f if nd_f else float('nan'))}",
        f"Fraction of singletons on reverse complement: "
        f"{fmt_double(ns_r / nd_r if nd_r else float('nan'))}",
    ]
    # Note: the reference prints the same "forward strand" sentence for the
    # empty-rev case too (copy-paste at team_mapper.cpp:524).
    if top_f is not None:
        lines.append(f"Minimizer on forward strand with max value: "
                     f"{decode_hash(top_f[0], k)}, Value: {top_f[1]}")
    else:
        lines.append("There are no minimizeres on forward strand after "
                     "removing (1-f) percent of most frequent minimizers.")
    if top_r is not None:
        lines.append(f"Minimizer on reverse complement with max value: "
                     f"{decode_hash(top_r[0], k)}, Value: {top_r[1]}")
    else:
        lines.append("There are no minimizeres on forward strand after "
                     "removing (1-f) percent of most frequent minimizers.")
    return "\n".join(lines)


def read_statistics(hashes: np.ndarray, valid: np.ndarray) -> str:
    """Per-read stats block printed in the mapping loop under -s
    (team_mapper.cpp:610-624): distinct minimizer count and singleton
    fraction of this read's window-win histogram (duplicates included)."""
    hs = hashes[valid]
    if hs.size == 0:
        distinct, counts = np.array([], dtype=np.uint32), np.array([], int)
    else:
        distinct, counts = np.unique(hs, return_counts=True)
    nd = len(distinct)
    ns = int((counts == 1).sum())
    frac = ns / nd if nd else float("nan")
    return (f"Number of distinct minimizers for forward strand: {nd}\n"
            f"Fraction of singletons on forward strand: {fmt_double(frac)}")
