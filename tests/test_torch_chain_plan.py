"""K1's two-level chain DP (csrc/lis_chain.cu), replayed on the CPU.

K1 cuts a row into chunks of ``ops/chain.CHAIN_C`` = 32 matches.  For
chunk k it takes the predecessors in finished chunks from chunks
[q_lo[k], k) only (``chunk_q_lo``, the kernel's rule on the host), keeping
the largest packed state (lis << 16) | (0xFFFF - j) of the qualifying j per
column; then it resolves the chunk's columns in order, each from the
earlier columns of its chunk and that cross-chunk best.  ``_replay`` does
the same in numpy.  It must give every match the (lis, prev) of a direct
O(N^2) DP, and endpoints equal to the JAX package's lax ``chain.lis_chain``
and its Pallas kernel (``pallas_chain.lis_chain_sorted`` in interpret mode).
``q_lo`` must never drop a qualifying pair, and the wide path's scan start
(``chunk_scan_start``) must leave it as the direct rule gives it.
``chain_plan`` is held to its paths and their shared-memory bytes, and to
the ceiling of the wide path: every budget of the mapper's ladder up to the
16,777,216 length bucket.

Past 65,535 matches K1 takes its wide path: states (lis << 32) | (0xFFFFFFFF
- j) in 64 bits, and a serial scan that reduces the 32-bit key (lis << 5) |
(31 - lane).  ``_replay(..., wide=True)`` does that too, on every case above
and on rows of 65,535-70,000 matches with f ascending, where it must give
every match the (lis, prev) of a windowed direct DP (``_direct_sorted``).
On a colinear row of 2,200,000 matches, whose q_lo pass 65,535 (K1 keeps
them as 32-bit words in global scratch), q_lo and the replay of its last
chunks hold to the row's closed form.

Inputs: test_torch_chain._matches; repeat copies 4,999 and 5,000 apart;
unsorted f; runs of equal f; counts 0, 1, 31, 32, 33 and N in one batch; N
not a multiple of 32; an earliest-j tie across a chunk boundary; match
rows of the JAX package's ``find_matches`` on simulated reads (N <= 512);
for the wide state a colinear run of 70,000 (lis and the chosen j past
65,535), an earliest-j tie across a chunk boundary at j > 65,535, and counts
65,535, 65,536 and 65,537 in one batch; a colinear row of 2,200,000.
Tolerance: exact.
"""

import functools
import os

import jax
import numpy as np
import pytest

from bioinfo1_tpu.index import builder as jbuilder
from bioinfo1_tpu.ops import chain as jchain
from bioinfo1_tpu.ops import match as jmatch
from bioinfo1_tpu.ops import minimizer as jmz
from bioinfo1_tpu.ops import pallas_chain as jpc
from bioinfo1_tpu.pipeline import mapper as jmapper
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch.kernels import build
from bioinfo1_tpu_torch.ops import chain as tchain
from test_torch_chain import FIELDS, _matches
from torch_chain_rows import (TIE_COL, TIE_J1, TIE_J2, WIDE_COLINEAR_N,
                              WIDE_ROWS, colinear_q_lo, colinear_rows)

C = tchain.CHAIN_C
GAP = 5000


# ---- chain_plan -----------------------------------------------------------

def _bytes(path, N):
    """Shared bytes of a path by csrc/lis_chain.cu's layout."""
    n_pad = -(-N // C) * C
    head = 2 * (-(-(n_pad // C) // 8) * 8)
    if path == "wide":          # q_lo in a global scratch row
        return 0
    return head + {"shared": 14 * n_pad, "state": 6 * n_pad,
                   "scratch": 8 * (n_pad // C)}[path]


@pytest.mark.parametrize("N,path", [
    (1, "shared"), (33, "shared"), (1536, "shared"), (16000, "shared"),
    (16001, "state"), (24576, "state"), (36864, "state"), (37152, "state"),
    (37153, "scratch"), (49152, "scratch"), (65535, "scratch")])
def test_chain_plan_paths(N, path):
    plan = tchain.chain_plan(N)
    assert plan.path == path
    assert plan.smem_bytes == _bytes(path, N) <= build.SMEM_LIMIT
    assert plan.threads == tchain.CHAIN_THREADS
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512


@pytest.mark.parametrize("last,path", [(16000, "shared"), (37152, "state")])
def test_chain_plan_boundaries(last, path):
    """Each path ends at the last N whose bytes fit SMEM_LIMIT: one more
    match (another chunk) would not."""
    assert _bytes(path, last) <= build.SMEM_LIMIT < _bytes(path, last + 1)
    assert tchain.chain_plan(last + 1).path != path


@pytest.mark.parametrize("N", [65536, 65537, 73728, 98304, 786432,
                               2 ** 21, 2 ** 21 + 1, 2359296, 2 ** 22,
                               2 ** 26, 2 ** 27 - 1])
def test_chain_plan_wide_path(N):
    """Past 65,535 matches (the 16-bit index of the narrow state) every
    budget takes the wide path, with no dynamic shared memory, up to its
    ceiling of 2^27 - 1."""
    assert tchain.chain_plan(N - 1).path == ("scratch" if N == 65536
                                             else "wide")
    plan = tchain.chain_plan(N)
    assert plan.path == "wide"
    assert plan.smem_bytes == _bytes("wide", N) <= build.SMEM_LIMIT
    assert plan.threads == tchain.CHAIN_THREADS


def test_chain_plan_rejects_budgets_outside_the_packed_range():
    for N in (0, tchain._MAX_N + 1):
        with pytest.raises(ValueError, match="outside"):
            tchain.chain_plan(N)


def test_wide_ceiling_is_the_largest_lis_the_scan_key_holds():
    """The wide path's serial scan reduces the 32-bit key (lis << 5) | (31
    - lane), and lis <= N: the ceiling is the largest N whose key fits,
    and K1's C entry states the same."""
    assert tchain._MAX_N == 2 ** 27 - 1
    assert (tchain._MAX_N << 5 | 31) < 2 ** 32 <= (tchain._MAX_N + 1) << 5
    with open(os.path.join(os.path.dirname(tchain.__file__), os.pardir,
                           "csrc", "lis_chain.cu")) as fh:
        src = fh.read()
    assert "constexpr int kWideMaxN = (1 << 27) - 1;" in src


def _base_budget(cap):
    """The mapper's base match budget of a length bucket (~3L/8 in whole
    128s; pipeline/mapper.py of both packages)."""
    return -(-3 * cap // (8 * 128)) * 128


@pytest.mark.parametrize("cap", [196608, 262144, 393216, 524288, 786432,
                                 1048576])
def test_chain_plan_takes_every_long_bucket_budget_and_its_doubling(cap):
    """Reads of 131 kb to 1 Mb: both mappers put them in these length
    buckets, and the base budget of each, and the budget one overflow
    retry doubles it to, run on K1's wide path."""
    from bioinfo1_tpu_torch.pipeline import mapper as tmapper
    floor = tmapper.MapperConfig().k + tmapper.MapperConfig().w - 1
    assert {m._bucket_cap(cap, floor) for m in (jmapper, tmapper)} == {cap}
    base = _base_budget(cap)
    for N in (base, 2 * base):
        assert tchain.chain_plan(N).path == "wide", N


# Both mappers' length buckets from 196,608 to 16,777,216 (reads of 131 kb
# to 16.8 Mb).
LONG_CAPS = [c for p in range(18, 25) for c in (3 << (p - 2), 1 << p)]


def _ladder(cap):
    """The match budgets the mapper's ladder gives a read of bucket
    ``cap`` up to K1's ceiling: the base budget and its doublings (an
    overflow retry doubles it, or jumps to a power-of-two multiple that
    covers the need)."""
    base = _base_budget(cap)
    return [base << d for d in range(64) if base << d <= tchain._MAX_N]


def test_chain_plan_takes_the_ladder_of_every_bucket_to_16_mb():
    """Every bucket from 196,608 to 16,777,216: both mappers put the reads
    between the bucket below and it there, and chain_plan takes its base
    budget and every doubling up to the ceiling on the wide path, and
    refuses the next.
    That is four doublings of the largest bucket's base budget (6,291,456
    -> 100,663,296)."""
    from bioinfo1_tpu_torch.pipeline import mapper as tmapper
    floor = tmapper.MapperConfig().k + tmapper.MapperConfig().w - 1
    assert LONG_CAPS[0] == 196608 and LONG_CAPS[-1] == 16777216
    assert len(LONG_CAPS) == 14
    for below, cap in zip([131072] + LONG_CAPS, LONG_CAPS):
        for ln in (below + 1, cap):
            assert {m._bucket_cap(ln, floor)
                    for m in (jmapper, tmapper)} == {cap}, ln
        taken = _ladder(cap)
        assert len(taken) >= 5, cap
        for N in taken:
            assert tchain.chain_plan(N).path == "wide", (cap, N)
        with pytest.raises(ValueError, match="outside"):
            tchain.chain_plan(2 * taken[-1])
    assert _ladder(16777216)[4] == 100663296 <= tchain._MAX_N
    assert _base_budget(6291456) == 2359296 > 2 ** 21


def test_doubled_budget_of_the_98304_bucket_is_refused_by_both_packages():
    """The budget behind the fault on reads of ~98 kb (now repaired on the
    port's side): both mappers put a read of 98,096 bases in the 98,304
    length bucket with a base match budget of 36,864 (~3L/8), which an
    overflow retry doubles to 73,728.  The JAX Pallas chain, the TPU's
    kernel, refuses that budget when it is traced (its 16-bit packed
    index: the TPU's limit, kept as it is); the port's plan takes it, and
    the next bucket's doubled budget of 98,304, on K1's wide path, as the
    JAX package's lax chain on the CPU takes them."""
    from bioinfo1_tpu_torch.pipeline import mapper as tmapper
    cfg = tmapper.MapperConfig()
    floor = cfg.k + cfg.w - 1
    assert jmapper.MapperConfig().k + jmapper.MapperConfig().w - 1 == floor
    caps = {m._bucket_cap(98096, floor) for m in (jmapper, tmapper)}
    assert caps == {98304}
    base = -(-3 * 98304 // (8 * 128)) * 128
    assert base == 36864 and 2 * base == 73728
    f = jax.numpy.zeros((1, 2 * base), jax.numpy.int32)
    with pytest.raises(ValueError, match="packed-index range"):
        jpc.lis_chain(f, f, jax.numpy.zeros((1,), jax.numpy.int32),
                      interpret=True)
    assert tchain.chain_plan(base).path == "state"
    assert _base_budget(98304) == base
    assert 2 * _base_budget(131072) == 98304
    for N in (2 * base, 2 * _base_budget(131072)):
        assert tchain.chain_plan(N).path == "wide"


# ---- the two-level replay ---------------------------------------------------

def _qualifies(f, r, j, i):
    """j is a predecessor of i (j, i may be arrays)."""
    return ((f[j] < f[i]) & (f[i] - f[j] < GAP)
            & (r[j] < r[i]) & (r[i] - r[j] < GAP))


def _direct(f, r, n):
    """Per-match (lis, prev) of the O(N^2) DP: prev = the earliest j of
    the longest qualifying predecessors, -1 for none."""
    lis = np.ones(n, np.int64)
    prev = np.full(n, -1, np.int64)
    for i in range(1, n):
        js = np.arange(i)
        ok = _qualifies(f, r, js, i)
        if ok.any():
            best = lis[js[ok]].max()
            lis[i] = best + 1
            prev[i] = js[ok][lis[js[ok]] == best][0]
    return lis, prev


def _direct_sorted(f, r, n):
    """_direct for f ascending: the predecessors of i lie among the j with
    f_j in (f_i - 5000, f_i), found by bisection, so the DP is exact in
    O(N x window)."""
    assert np.all(f[1:n] >= f[:n - 1])
    lis = np.ones(n, np.int64)
    prev = np.full(n, -1, np.int64)
    lo = np.searchsorted(f[:n], f[:n] - (GAP - 1), side="left")
    for i in range(1, n):
        js = np.arange(lo[i], i)
        ok = _qualifies(f, r, js, i)
        if ok.any():
            best = lis[js[ok]].max()
            lis[i] = best + 1
            prev[i] = js[ok][lis[js[ok]] == best][0]
    return lis, prev


# The packed state of a path: the shift of lis and the j field's mask.
STATE = {False: (16, 0xFFFF), True: (32, 0xFFFFFFFF)}


def _replay(f, r, n, wide=False, chunks=None, packed=None):
    """K1's two-level DP: chunks of C, the cross phase over chunks [q_lo,
    k) with the full pair test, then the in-chunk scan, on packed states
    (lis << 16) | (0xFFFF - j), or with ``wide`` (lis << 32) | (0xFFFFFFFF
    - j), whose scan reduces the key (lis << 5) | (31 - lane) of the
    earlier columns (a 32-bit word) and unpacks the best one's state from
    it.  ``chunks`` (default all) replays those alone, on the states in
    ``packed`` (default none yet) before them."""
    shift, mask = STATE[wide]
    packed = np.zeros(n, np.int64) if packed is None else packed.copy()
    prev = np.full(n, -1, np.int64)
    q_los = tchain.chunk_q_lo(f, n)
    for k in range(len(q_los)) if chunks is None else chunks:
        q_lo = q_los[k]
        cols = np.arange(k * C, min(n, k * C + C))
        js = np.arange(q_lo * C, k * C)
        ok = _qualifies(f, r, js[:, None], cols[None, :])
        ext = np.where(ok, packed[js][:, None], 0).max(axis=0, initial=0)
        key = np.zeros(len(cols), np.int64)
        for t, i in enumerate(cols):
            inner = cols[:t]
            if wide:
                b = int(np.where(_qualifies(f, r, inner, i), key[:t],
                                 0).max(initial=0))
                cand = ((b >> 5) << 32 | (mask - (k * C + C - 1 - (b & 31)))
                        if b else 0)
            else:
                cand = int(np.where(_qualifies(f, r, inner, i),
                                    packed[inner], 0).max(initial=0))
            best = max(cand, int(ext[t]))
            lis = (best >> shift) + 1
            key[t] = lis << 5 | (C - 1 - t)
            assert not wide or key[t] < 2 ** 32
            packed[i] = lis << shift | (mask - i)
            prev[i] = mask - (best & mask) if best else -1
    return packed >> shift, prev


def _endpoints(f, r, n, lis, prev):
    """(length, q_start, q_end, t_start, t_end) from per-match (lis, prev);
    a row without matches reads its endpoints from lane 0."""
    if n == 0:
        return 0, f[0], f[0], r[0], r[0]
    end = int(np.argmax(lis[:n]))
    root = end
    while prev[root] >= 0:
        root = prev[root]
    return int(lis[end]), f[root], f[end], r[root], r[end]


def _repeat_rows():
    """Repeat copies exactly 4,999 apart (they chain) and 5,000 apart (they
    do not), on both axes, with noise rows between."""
    rng = np.random.default_rng(4)
    B, N = 6, 256
    f = np.zeros((B, N), np.int32)
    r = np.zeros((B, N), np.int32)
    cnt = np.full(B, N, np.int32)
    for b in range(B):
        step = (4999, 5000)[b % 2]
        base = 1 + np.sort(rng.integers(0, 3 * step, N))
        grid = 1 + step * (np.arange(N) // 8)      # 8 equal f per copy
        f[b] = base if b < 4 else grid
        r[b] = (base + step * rng.integers(0, 3, N) if b < 4
                else grid + rng.integers(0, 2, N))
    return f, r, cnt


def _unsorted_rows():
    f, r, cnt = _matches(21, B=8, N=300)
    rng = np.random.default_rng(21)
    for b in range(8):
        perm = rng.permutation(int(cnt[b]))
        f[b, :cnt[b]] = f[b, perm]
        r[b, :cnt[b]] = r[b, perm]
    return f, r, cnt


def _equal_f_rows():
    """Runs of 1-40 equal f, some straddling chunk boundaries."""
    rng = np.random.default_rng(5)
    B, N = 6, 320
    f = np.zeros((B, N), np.int32)
    r = np.zeros((B, N), np.int32)
    for b in range(B):
        runs = rng.integers(1, 41, N)
        f[b] = np.repeat(1 + 700 * np.arange(N), runs)[:N]
        r[b] = f[b] + rng.integers(0, 600, N)
    return f, r, np.full(B, N, np.int32)


def _count_rows():
    """One batch with counts 0, 1, 31, 32, 33 and N = 96, junk past them."""
    f, r, _ = _matches(22, B=6, N=96)
    return f, r, np.array([0, 1, 31, 32, 33, 96], np.int32)


def _ragged_rows():
    """N = 200, not a multiple of 32."""
    return _matches(23, B=8, N=200)


def _tie_rows():
    """Earliest-j ties: column 40 (chunk 1) has equal-lis predecessors 3
    (chunk 0, the cross phase) and 35 (its own chunk, the serial scan);
    column 70 (chunk 2) has 10 and 50 (chunks 0 and 1, split over two
    warps).  The other matches chain with nothing (r falls as f rises)."""
    N = 96
    f = np.tile(10 + np.arange(N, dtype=np.int32), (2, 1))
    r = np.tile(1_000_000 - 100 * np.arange(N, dtype=np.int32), (2, 1))
    r[0, [3, 35, 40]] = (100, 100, 200)
    r[1, [10, 50, 70]] = (1000, 1000, 1100)
    return f, r, np.full(2, N, np.int32)


@functools.lru_cache(maxsize=None)
def _find_matches_rows():
    """Both strands' match rows of the JAX package's find_matches for four
    simulated ONT reads of 6-12 kb on a 60 kb genome (k = 13, w = 20: ~1
    match in 30 bases, so a row's f spans several 5,000 windows), budget
    512."""
    k, w = 13, 20
    rng = np.random.default_rng(12)
    genome = simulate.random_genome(60000, rng)
    index = jbuilder.build_index(genome.tobytes().decode("latin1"), k, w,
                                 0.001)
    recs = simulate.simulate_reads(genome, rng.integers(6000, 12000, 4), rng)
    arr, lens = jmapper._pack_reads([s for _, s in recs], k + w - 1)
    mres = jmz.minimize_batch(arr, lens, k, w)
    rows = []
    for strand in (index.fwd, index.rev):
        got = jax.device_get(jmatch.find_matches(
            mres.hashes, mres.pos, mres.dedup_keep, strand.hash_sorted,
            strand.pos_sorted, 512))
        rows.append((got.f_pos, got.r_pos, got.count))
    return tuple(np.concatenate(x).astype(np.int32) for x in zip(*rows))


CASES = {
    "matches": lambda: _matches(20, B=10, N=384),
    "repeats": _repeat_rows,
    "unsorted": _unsorted_rows,
    "equal_f": _equal_f_rows,
    "counts": _count_rows,
    "ragged": _ragged_rows,
    "tie": _tie_rows,
    "find_matches": _find_matches_rows,
}


@pytest.mark.parametrize("case", list(CASES))
def test_replay_equals_direct_dp_and_jax(case):
    f, r, cnt = CASES[case]()
    lax = jax.device_get(jchain.lis_chain(f, r, cnt))
    pallas = jax.device_get(jpc.lis_chain_sorted(f, r, cnt, interpret=True))
    for b in range(f.shape[0]):
        fb, rb = f[b].astype(np.int64), r[b].astype(np.int64)
        n = int(cnt[b])
        want = _direct(fb, rb, n)
        for wide in (False, True):
            lis, prev = _replay(fb, rb, n, wide)
            np.testing.assert_array_equal(lis, want[0],
                                          err_msg=f"lis row {b} {wide}")
            np.testing.assert_array_equal(prev, want[1],
                                          err_msg=f"prev row {b} {wide}")
        got = _endpoints(fb, rb, n, lis, prev)
        for field, x in zip(FIELDS, got):
            assert x == getattr(lax, field)[b], (field, b)
            assert x == getattr(pallas, field)[b], (field, b)
    if case == "tie":
        assert list(lax.length) == [2, 2]
        assert list(lax.q_start) == [f[0, 3], f[1, 10]]
    if case == "find_matches":
        assert int(lax.length.max()) > 20


def _q_lo_direct(f, n):
    """The q_lo rule searched from chunk 0 (as the narrow paths do)."""
    x = np.asarray(f[:n], np.int64)
    fmin = np.array([x[q:q + C].min() for q in range(0, n, C)], np.int64)
    fmax = np.array([x[q:q + C].max() for q in range(0, n, C)], np.int64)
    q_lo = np.arange(len(fmin))
    for k in range(len(fmin)):
        ok = np.flatnonzero((fmax[:k] > fmin[k] - GAP) & (fmin[:k] < fmax[k]))
        if len(ok):
            q_lo[k] = ok[0]
    return q_lo


def _rows_of(rows, case):
    """(f, n) of every row of a CASES ("narrow") or WIDE_ROWS ("wide")
    case."""
    if rows == "narrow":
        f, _, cnt = CASES[case]()
        return [(f[b].astype(np.int64), int(cnt[b]))
                for b in range(f.shape[0])]
    return [(f, n) for f, _, n in WIDE_ROWS[case]()]


@pytest.mark.parametrize("rows,case", [("narrow", c) for c in CASES]
                         + [("wide", c) for c in WIDE_ROWS],
                         ids=lambda x: x)
def test_scan_start_leaves_q_lo_as_the_direct_rule_gives_it(rows, case):
    """The wide path starts each chunk's q_lo scan at chunk_scan_start (a
    search of the running max of fmax): q_lo equals the rule searched from
    chunk 0, and the start is never past it.  On sorted rows the start
    skips every chunk the scan from 0 would test in vain."""
    skipped = 0
    for f, n in _rows_of(rows, case):
        want = _q_lo_direct(f, n)
        got = tchain.chunk_q_lo(f, n)
        np.testing.assert_array_equal(got, want, err_msg=case)
        fmin, fmax = tchain._chunk_bounds(f, n)
        start = tchain.chunk_scan_start(fmin, fmax)
        assert np.all(start <= got), case
        skipped += int(start.sum())
        if n and np.all(f[1:n] >= f[:n - 1]):
            # sorted f: the first chunk reaching the window qualifies
            np.testing.assert_array_equal(start, got, err_msg=case)
    if rows == "wide" or case in ("matches", "repeats", "equal_f",
                                  "find_matches"):
        assert skipped > 0


@pytest.mark.parametrize("case", list(CASES))
def test_q_lo_never_drops_a_qualifying_pair(case):
    """Every predecessor j of i lies in i's chunk or in a chunk at or after
    q_lo of i's chunk; and q_lo skips something on the long sorted rows."""
    f, r, cnt = CASES[case]()
    skipped = 0
    for b in range(f.shape[0]):
        fb, rb = f[b].astype(np.int64), r[b].astype(np.int64)
        n = int(cnt[b])
        q_lo = tchain.chunk_q_lo(fb, n)
        assert len(q_lo) == -(-n // C)
        assert all(0 <= q <= k for k, q in enumerate(q_lo))
        skipped += int(q_lo.sum())
        j, i = np.nonzero(np.triu(_qualifies(
            fb, rb, np.arange(n)[:, None], np.arange(n)[None, :]), 1))
        assert np.all(j // C >= q_lo[i // C]), (case, b)
    if case in ("matches", "repeats", "equal_f", "find_matches"):
        assert skipped > 0


# ---- the wide state past 65,535 matches ------------------------------------

@pytest.mark.parametrize("case", list(WIDE_ROWS))
def test_wide_replay_equals_direct_dp_past_the_16_bit_index(case):
    """The wide state on rows of 65,535-70,000 matches (torch_chain_rows),
    each a budget K1 runs on its wide path: every match's (lis, prev)
    equals the windowed direct DP's, and the endpoints follow."""
    for f, r, n in WIDE_ROWS[case]():
        assert tchain.chain_plan(len(f)).path == "wide"
        lis, prev = _replay(f, r, n, wide=True)
        want = _direct_sorted(f, r, n)
        np.testing.assert_array_equal(lis, want[0], err_msg=case)
        np.testing.assert_array_equal(prev, want[1], err_msg=case)
        length, q_start, q_end, _, _ = _endpoints(f, r, n, lis, prev)
        if case == "colinear":
            assert length == n == 70000 and prev[n - 1] == n - 2
            assert (q_start, q_end) == (1, 70000)
        if case == "tie":
            assert prev[TIE_COL] == TIE_J1 and TIE_J1 // C < TIE_COL // C
            assert TIE_J2 // C == TIE_COL // C
            assert q_start == f[TIE_J1] and length == 70000 - TIE_COL + 1


def test_wide_replay_past_the_16_bit_chunk_index():
    """A colinear row of 2,200,000 matches (68,750 chunks; budgets past
    2,097,152 take K1's wide path with q_lo as 32-bit words): q_lo equals
    the row's closed form, max(k - 157, 0), past 65,535 from chunk 65,693
    on; the replay of chunks there and at the row's end, on the closed
    form's states before them, gives each match lis = j + 1 and prev = j -
    1, and keys past 2^21 << 5 that fit 32 bits."""
    ((f, r, n),) = colinear_rows(WIDE_COLINEAR_N)
    assert tchain.chain_plan(n).path == "wide" and n > 2 ** 21
    q_lo = tchain.chunk_q_lo(f, n)
    np.testing.assert_array_equal(q_lo, colinear_q_lo(n))
    assert q_lo.max() > 0xFFFF and q_lo[65693] == 65536
    j = np.arange(n, dtype=np.int64)
    closed = (j + 1) << 32 | (0xFFFFFFFF - j)    # the closed form's states
    K = len(q_lo)
    chunks = [65692, 65693, 65694, K - 2, K - 1]
    lis, prev = _replay(f, r, n, wide=True, chunks=chunks, packed=closed)
    for k in chunks:
        cols = j[k * C:min(n, k * C + C)]
        np.testing.assert_array_equal(lis[cols], cols + 1, err_msg=k)
        np.testing.assert_array_equal(prev[cols], cols - 1, err_msg=k)
    assert lis[n - 1] == n and (n << 5 | 31) < 2 ** 32
