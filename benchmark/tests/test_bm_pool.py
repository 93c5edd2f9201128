"""The genome and the read pool: made from the seed alone, the same
lengths for every seed, the ONT profile, the genome's repeat census."""

import json
import os

import numpy as np
import pytest

from benchmark import simulate
from conftest import ROOT

TRAFFIC = os.path.join(ROOT, "benchmark", "traffic")


def _traffic(name, reads=None):
    with open(os.path.join(TRAFFIC, name + ".json")) as fh:
        t = json.load(fh)
    if reads:
        t["pool_reads"] = reads
    return t


def _pool(seed, traffic, genome_len=200_000):
    g = simulate.random_genome(genome_len, simulate.rng_for(seed, 0))
    return g, simulate.make_pool(g, traffic, simulate.rng_for(seed, 1))


@pytest.mark.parametrize("name", ["ont_2_8kb", "ont_50kb"])
def test_same_seed_same_pool(name):
    t = _traffic(name, reads=40)
    g1, p1 = _pool(2 ** 31 + 11, t)
    g2, p2 = _pool(2 ** 31 + 11, t)
    assert np.array_equal(g1, g2) and p1 == p2
    g3, p3 = _pool(2 ** 31 + 12, t)
    assert not np.array_equal(g1, g3) and p1 != p3
    # Every seed draws the same fragment lengths, in its own order.
    assert sorted(ln for ln, _ in p1) == sorted(ln for ln, _ in p3)
    assert [ln for ln, _ in p1] != [ln for ln, _ in p3]


def test_lengths_of_the_mix():
    t = _traffic("ont_2_8kb")
    lens = simulate.pool_lengths(t)
    assert len(lens) == 8192
    short = lens[lens <= 500]
    assert len(short) == 819 and short.min() == 200 and short.max() == 500
    # The rest: a truncated log-normal over 2-8 kb, median ~4 kb, with no
    # length repeated more than a few times (no spikes).
    long = lens[lens > 500]
    assert long.min() >= 2000 and long.max() <= 8000
    assert 3700 <= np.median(long) <= 4300
    assert np.bincount(long).max() <= 4
    assert 0.05 < np.mean(long < 2500) < 0.2
    assert 0.02 < np.mean(long > 7000) < 0.1
    lens50 = simulate.pool_lengths(_traffic("ont_50kb"))
    assert len(lens50) == 192
    assert lens50.min() == 45000 and lens50.max() == 55000


def test_error_profile():
    """Reads are ~1.7% shorter than their fragments (3% insertions, 4%
    deletions, mean length 1/0.6), about half reverse-complemented, and
    align back to where they came from."""
    rng = np.random.default_rng(5)
    frag = simulate.random_genome(400_000, rng)
    got = simulate.mutate_many([frag], rng, 0.05, 0.03, 0.04, 0.6)[0]
    ratio = len(got) / len(frag)
    assert 0.975 < ratio < 0.99, ratio
    t = _traffic("ont_2_8kb", reads=200)
    g, pool = _pool(7, t)
    gb = g.tobytes()
    kmers = {gb[i:i + 12] for i in range(len(gb) - 11)}
    fwd = 0
    for ln, read in pool:
        r = read.encode("latin1")
        assert set(r) <= set(b"ACGT")
        rc = simulate.COMP[np.frombuffer(r, np.uint8)[::-1]].tobytes()
        hits = [sum(s[i:i + 12] in kmers for i in range(0, len(s) - 12, 6))
                for s in (r, rc)]
        assert max(hits) > 0
        fwd += hits[0] > hits[1]
    assert 0.35 < fwd / len(pool) < 0.65


def test_pool_is_fast():
    import time
    t = _traffic("ont_2_8kb")
    t0 = time.perf_counter()
    _pool(3, t, genome_len=4_641_652)
    assert time.perf_counter() - t0 < 30


def test_class_lengths_by_hand():
    even = simulate.class_lengths({"lo": 10, "hi": 20}, 3)
    assert even.tolist() == [10, 15, 20]
    # A log-normal truncated at its own median: every length below it.
    logn = simulate.class_lengths({"dist": "lognormal", "median": 1000,
                                   "sigma": 1.0, "lo": 10, "hi": 1000}, 4)
    assert logn.tolist() == sorted(logn.tolist()) and logn.max() <= 1000
    assert logn.min() >= 10 and len(set(logn.tolist())) == 4
    with pytest.raises(ValueError):
        simulate.class_lengths({"dist": "gamma", "lo": 1, "hi": 2}, 2)


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "ecoli_paf.json")) as fh:
        return json.load(fh)


def test_genome_from_the_seed_with_the_census():
    """The configuration's generator: the same genome for one seed, another
    for the next; its rRNA-like copies and tandem loci repeat 15-mers that
    uniform bases of the same length would not."""
    g = dict(_config()["genome"], length=1_000_000)
    a = simulate.make_genome(g, 2 ** 31 + 21)
    assert len(a) == 1_000_000 and set(np.unique(a).tolist()) <= set(b"ACGT")
    assert np.array_equal(a, simulate.make_genome(g, 2 ** 31 + 21))
    assert not np.array_equal(a, simulate.make_genome(g, 2 ** 31 + 22))

    def repeated(seq):
        """15-mers at 6 or more positions."""
        v = np.lib.stride_tricks.sliding_window_view(seq, 15)
        _, n = np.unique(v[::3], axis=0, return_counts=True)
        return int((n >= 2).sum())

    flat = simulate.random_genome(1_000_000, simulate.rng_for(5, 0))
    assert repeated(a) > 20 * max(1, repeated(flat))


def test_unknown_generator_is_refused():
    with pytest.raises(ValueError):
        simulate.make_genome({"generator": "no_such", "length": 10}, 1)
