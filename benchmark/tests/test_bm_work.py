"""The work counts against hand-computed ones on small shapes."""

import numpy as np
import pytest

from benchmark import work


def _band_cells_brute(q, t, W):
    return sum(1 for i in range(1, q + 1) for j in range(1, t + 1)
               if -W <= j - i <= W - 1)


@pytest.mark.parametrize("q,t,W", [(5, 7, 128), (300, 310, 128),
                                   (300, 200, 128), (1, 1, 128),
                                   (0, 9, 128), (700, 900, 256)])
def test_band_cells(q, t, W):
    assert work.band_cells([q], [t], W) == _band_cells_brute(q, t, W)


def test_band_work_bytes():
    # Two pairs of a (2, 300) x (2, 400) call at band 100 (W = 128).
    w = work.band_work(300, 400, [300, 250], [310, 400], 100, False)
    cells = _band_cells_brute(300, 310, 128) + _band_cells_brute(250, 400,
                                                                 128)
    assert w["work"] == cells
    assert w["bytes"] == 2 * 300 + 2 * 400 + 16 + 24
    assert w["ops"] == 7 * cells
    wp = work.band_work(300, 400, [300, 250], [310, 400], 100, True)
    assert wp["bytes"] == w["bytes"] + (cells + 3) // 4
    assert wp["ops"] == 12 * cells


def test_band_shapes():
    assert work.band_shapes(4000, 9000, 256) == (256, 4096, 4352,
                                                 4095 + 4353 - 1)
    assert work.band_shapes(100, 50, 1)[:3] == (128, 128, 128)


def _pairs_brute(f):
    return sum(1 for i in range(len(f)) for j in range(i)
               if f[i] - 5000 < f[j] < f[i])


def test_window_pairs():
    rng = np.random.default_rng(3)
    for _ in range(20):
        n = int(rng.integers(0, 200))
        f = np.sort(rng.integers(1, 30000, n))
        if n > 5 and rng.random() < 0.5:
            f[-3:] = rng.integers(1, 30000, 3)    # an unsorted tail
        if n > 8 and rng.random() < 0.3:
            f[4] = 1                              # an early descent
        assert work.window_pairs(f) == _pairs_brute(f.tolist())
    assert work.window_pairs([10, 10, 10]) == 0
    assert work.window_pairs([1, 5000, 5001]) == 2


def test_chain_work():
    f = np.array([[1, 2, 6000, 0], [7, 7, 8, 9]])
    w = work.chain_work(f, np.array([3, 4]))
    assert w["work"] == 1 + 5 and w["ops"] == 30
    assert w["bytes"] == 8 * 7 + 48


def test_full_work_and_bound():
    w = work.full_work(10, 20, [10, 4], [20, 30])
    assert w["work"] == 200 + 80 and w["bytes"] == 2 * 10 + 2 * 20 + 40
    by_ops = {"bytes": 0, "ops": work.PEAK_INT32_PER_S}
    by_bytes = {"bytes": work.PEAK_BYTES_PER_S * 2, "ops": 1}
    assert work.bound_s(by_ops) == pytest.approx(1.0)
    assert work.bound_s(by_bytes) == pytest.approx(2.0)
