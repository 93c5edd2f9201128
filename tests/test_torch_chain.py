"""Plain LIS chain of the port against the JAX package, exactly.

The JAX side runs both its lax ``chain.lis_chain`` and the Pallas kernel
(``pallas_chain.lis_chain_sorted``) in interpret mode; the port's plain
version must equal both on every field of every row (rows without matches
included: length 0, endpoints read from lane 0).
"""

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.ops import chain as jchain
from bioinfo1_tpu.ops import pallas_chain as jpc
from bioinfo1_tpu_torch.ops import chain as tchain

FIELDS = ("length", "q_start", "q_end", "t_start", "t_end")


def _matches(seed, B, N):
    """Match rows mixing ascending runs, repeat copies ~5000 apart (both
    sides of the 5000 window), random jumps, empty and full rows."""
    rng = np.random.default_rng(seed)
    f = np.zeros((B, N), np.int32)
    r = np.zeros((B, N), np.int32)
    cnt = rng.integers(0, N + 1, B).astype(np.int32)
    cnt[0], cnt[1] = 0, N
    for b in range(B):
        n = int(cnt[b])
        fs = np.sort(rng.integers(1, 9000, n)).astype(np.int32)
        copies = rng.integers(0, 3, n).astype(np.int32)
        rs = fs + copies * 4999 + rng.integers(-40, 40, n).astype(np.int32)
        jump = rng.random(n) < 0.1
        rs[jump] = rng.integers(1, 30000, int(jump.sum()))
        f[b, :n] = fs
        r[b, :n] = np.maximum(rs, 1)
        # Leave junk past count: it must be ignored.
        f[b, n:] = rng.integers(0, 50, N - n)
    return f, r, cnt


@pytest.mark.parametrize("N", [128, 384])
def test_plain_lis_chain_matches_jax(N):
    f, r, cnt = _matches(N, B=12, N=N)
    got = tchain.lis_chain(torch.from_numpy(f), torch.from_numpy(r),
                           torch.from_numpy(cnt))
    lax = jax.device_get(jchain.lis_chain(f, r, cnt))
    pallas = jax.device_get(jpc.lis_chain_sorted(f, r, cnt, interpret=True))
    assert int(lax.length.max()) > 3
    for field in FIELDS:
        g = getattr(got, field).numpy()
        np.testing.assert_array_equal(g, getattr(lax, field), err_msg=field)
        np.testing.assert_array_equal(g, getattr(pallas, field),
                                      err_msg=field)


def test_predecessor_window_edges():
    """Predecessors at distance 4999 qualify, at 5000 do not; ties go to
    the earliest j; a count-0 row reads its endpoints from lane 0."""
    cases = [
        [(1, 1), (5000, 5000)],                  # 4999 apart: chain of 2
        [(1, 1), (5001, 5001)],                  # 5000 apart: no chain
        [(1, 1), (1, 2), (3, 3)],                # f equal: not a predecessor
        [(1, 10), (2, 5), (3, 11), (4, 12)],     # earliest j on a tie
        [],
    ]
    N = 8
    f = np.zeros((len(cases), N), np.int32)
    r = np.zeros((len(cases), N), np.int32)
    cnt = np.zeros(len(cases), np.int32)
    for i, c in enumerate(cases):
        for j, (ff, rr) in enumerate(c):
            f[i, j], r[i, j] = ff, rr
        cnt[i] = len(c)
    f[4, 0], r[4, 0] = 7, 9
    got = tchain.lis_chain(torch.from_numpy(f), torch.from_numpy(r),
                           torch.from_numpy(cnt))
    want = jax.device_get(jchain.lis_chain(f, r, cnt))
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      getattr(want, field), err_msg=field)
    assert got.length.tolist() == [2, 1, 2, 3, 0]
    assert (int(got.q_start[4]), int(got.t_end[4])) == (7, 9)
