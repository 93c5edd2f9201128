"""The yardstick's arithmetic: the card's peaks, the operations each kernel's
function needs, and the work and bytes of one kernel call from its
arguments.

Frozen copies, so that a later change to the program cannot move the
yardstick: ``PEAK_*`` and ``NEEDED_OPS`` from ``chip_smoke.py``
(``PEAK_BYTES_PER_S``, ``PEAK_INT32_PER_S``, ``NEEDED_OPS``),
``band_cells`` from ``bench_torch.band_cells``, ``band_work`` /
``full_work`` / ``chain_work`` / ``bound`` from ``chip_smoke.py``, and
``band_shapes`` from ``bioinfo1_tpu_torch/ops/band.py`` (the shapes a
banded call sweeps, which its arguments alone decide).  Everything here
runs on host arrays; nothing imports the program.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM; 67 TFLOP/s of float32
# outside the tensor cores is one FMA per lane and clock, i.e. 33.5e12
# instruction-lanes per second, the rate at which the same lanes issue
# int32 instructions.  Both assume the card's full 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_PER_S = 67e12 / 2

# Int32 operations the FUNCTION needs per unit of work, whatever kernel
# computes it (borders, the '-' rule, the local clamp, addressing and loads
# are left out):
#   pair (K1): two subtracts, two unsigned compares, one max: 5.
#   cell (K2, K3): compare the bases, select match / mismatch, three adds,
#     two maxes: 7.
#   cell with parents (K4): the same 7, two compares and two selects for
#     which of M, I, D won, one shift-add of the code into its byte: 12.
#   step (K5): extract the 2-bit code, move i and j, the next offset: 5.
NEEDED_OPS = {"chain": 5, "band": 7, "band_parents": 12, "full": 7,
              "walk": 5}

LANES = 128
CHAIN_GAP = 5000


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_shapes(n: int, m: int, band: int) -> tuple:
    """(W, n_pad, m_eff, n_steps) of a banded call on (B, n) x (B, m)."""
    W = _round_up(band, LANES)
    n_pad = _round_up(max(n, 128), 128)
    m_eff = _round_up(max(min(m, n + W), 128), 128)
    n_steps = (n_pad - 1) + (m_eff + 1) - 1
    return W, n_pad, m_eff, n_steps


def band_cells(q_lens, t_lens, W: int) -> int:
    """Cells of each pair's q_len x t_len matrix that lie in a W-lane band
    (diagonal offsets j - i in [-W, W - 1]), summed over the pairs: the
    cells a banded DP has to compute.  Closed form per row i:
    min(t, i + W - 1) - max(i - W, 1) + 1, clipped at 0, summed over
    i = 1..q."""
    total = 0
    for q, t in zip(np.asarray(q_lens, np.int64).tolist(),
                    np.asarray(t_lens, np.int64).tolist()):
        if q <= 0 or t <= 0:
            continue
        i = np.arange(1, q + 1, dtype=np.int64)
        row = np.minimum(t, i + (W - 1)) - np.maximum(i - W, 1) + 1
        total += int(np.clip(row, 0, None).sum())
    return total


def band_work(n: int, m: int, q_lens, t_lens, band: int,
              want_parents: bool) -> dict:
    """What a banded call on (B, n) x (B, m) needs: the cells of each pair's
    matrix inside the band (``work``), and the bytes it must move - both
    inputs and the lengths read once, three int32 outputs written once and,
    with parents, two bits a cell."""
    W, _, m_eff, _ = band_shapes(n, m, band)
    ql = np.asarray(q_lens, np.int64)
    tl = np.minimum(np.asarray(t_lens, np.int64), m_eff)
    B = len(ql)
    cells = band_cells(ql, tl, W)
    nbytes = B * n + B * m + 8 * B + 12 * B
    if want_parents:
        nbytes += (cells + 3) // 4
    return {"work": cells, "bytes": nbytes,
            "ops": cells * NEEDED_OPS["band_parents" if want_parents
                                      else "band"]}


def full_work(n: int, m: int, q_lens, t_lens) -> dict:
    """What a full-matrix call needs: the cells inside each pair's matrix
    and its bytes (inputs and lengths read once, three outputs written)."""
    qa = np.clip(np.asarray(q_lens, np.int64), 0, n)
    ta = np.clip(np.asarray(t_lens, np.int64), 0, m)
    B = len(qa)
    cells = int((qa * ta).sum())
    return {"work": cells, "bytes": B * n + B * m + 20 * B,
            "ops": cells * NEEDED_OPS["full"]}


def window_pairs(f_row) -> int:
    """Pairs j < i of one chain row with f_i - 5000 < f_j < f_i: the pairs
    whose r test decides anything.  The sorted head of the row by binary
    search, the rest (a read's suffix end-windows, a few matches) by a
    scan over what precedes each."""
    x = np.asarray(f_row, np.int64)
    n = len(x)
    if n < 2:
        return 0
    desc = np.flatnonzero(x[1:] < x[:-1])
    head = n if not len(desc) else int(desc[0]) + 1
    h = x[:head]
    lo = np.searchsorted(h, h - (CHAIN_GAP - 1), side="left")
    hi = np.searchsorted(h, h, side="left")
    count = int(np.clip(hi - lo, 0, None).sum())
    for i in range(head, n):
        prior = x[:i]
        count += int(((prior > x[i] - CHAIN_GAP) & (prior < x[i])).sum())
    return count


def chain_work(f, cnt) -> dict:
    """What a chain call on (R, N) matches needs: its window pairs, and the
    bytes (the valid matches' f and r read once, the counts, five int32
    outputs a row)."""
    fa = np.asarray(f)
    ca = np.clip(np.asarray(cnt, np.int64), 0, fa.shape[1])
    pairs = sum(window_pairs(fa[b, :int(ca[b])]) for b in range(fa.shape[0]))
    nbytes = 8 * int(ca.sum()) + 24 * len(ca)
    return {"work": pairs, "bytes": nbytes,
            "ops": pairs * NEEDED_OPS["chain"]}


def bound_s(work: dict) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the int32 issue rate."""
    return max(work["bytes"] / PEAK_BYTES_PER_S,
               work["ops"] / PEAK_INT32_PER_S)
