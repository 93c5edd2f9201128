"""Match rows past K1's 16-bit index (budgets > 65,535: its wide path),
and a colinear row past its old 16-bit chunk index (WIDE_COLINEAR_N).

Shared by the CPU replay (``test_torch_chain_plan.py``) and the card's
tests (``test_torch_kernels_cuda.py``); no JAX here.  Each builder returns
a list of (f, r, count) rows, int64 numpy arrays of one budget, f ascending
over the valid matches.
"""

import numpy as np

# The tie row's column and its two equal predecessors: J1 in the chunk
# before the column's (K1's cross phase), J2 in the column's own (its serial
# scan); all three past 65,535.
TIE_COL, TIE_J1, TIE_J2 = 65700, 65690, 65697
# A colinear row past 2,097,152 matches (65,536 chunks of 32): its chunks'
# q_lo pass 65,535, the old wide path's 16-bit chunk index.
WIDE_COLINEAR_N = 2_200_000


def colinear_rows(n: int = 70000) -> list:
    """f = r = 1..n: every match extends the chain, so lis reaches n and
    each match's predecessor is the one before it."""
    f = np.arange(1, n + 1, dtype=np.int64)
    return [(f, f.copy(), n)]


def colinear_q_lo(n: int) -> np.ndarray:
    """K1's q_lo on colinear_rows(n), in closed form: chunk q (f from 32q +
    1 to 32q + 32) qualifies for chunk k iff 32q + 32 > 32k + 1 - 5000,
    i.e. q >= k - 157."""
    return np.maximum(np.arange(-(-n // 32)) - 157, 0)


def tie_rows() -> list:
    """70,000 matches, f ascending by 1; r falls (nothing chains) but at
    TIE_J1 and TIE_J2 (equal r, lis 1 each) and from TIE_COL on, a colinear
    run that chains from both: the earliest, TIE_J1, must win."""
    i = np.arange(70000, dtype=np.int64)
    f = 10 + i
    r = 2_000_000_000 - 100 * i
    r[[TIE_J1, TIE_J2]] = 1_000_000
    r[TIE_COL:] = 1_000_100 + i[TIE_COL:] - TIE_COL
    return [(f, r, 70000)]


def count_rows() -> list:
    """One batch of budget 65,537 with counts 65,535, 65,536 and 65,537:
    sorted f, repeat copies 4,999 apart, junk past the count."""
    rng = np.random.default_rng(31)
    N = 65537
    rows = []
    for n in (65535, 65536, 65537):
        f = np.zeros(N, np.int64)
        r = np.zeros(N, np.int64)
        f[:n] = np.sort(rng.integers(1, 4 * N, n))
        r[:n] = np.maximum(f[:n] + rng.integers(0, 3, n) * 4999
                           + rng.integers(-30, 30, n), 1)
        f[n:] = r[n:] = rng.integers(1, 100, N - n)
        rows.append((f, r, n))
    return rows


WIDE_ROWS = {"colinear": colinear_rows, "tie": tie_rows,
             "counts": count_rows}


def batch(rows) -> tuple:
    """(f, r, count) of rows of one budget as (R, N) / (R,) int32 arrays."""
    f = np.stack([x[0] for x in rows]).astype(np.int32)
    r = np.stack([x[1] for x in rows]).astype(np.int32)
    return f, r, np.array([x[2] for x in rows], np.int32)
