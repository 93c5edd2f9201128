"""Genome and read pool of a cell, made from ``--seed``.

The genome comes from the generator that the configuration names
(``genome.generator``: ``benchmark/genomes/<generator>.py``, a
``make(length, rng, **params)``), so that a new genome is a file and a
configuration.  The pool is a frozen, vectorised copy of
``bioinfo1_tpu_torch/utils/simulate.py``'s ONT error model (``mutate_read``,
``simulate_reads``), so that a later change to the program cannot move the
traffic.  Per fragment base:
a substitution (a uniform random base, so a quarter are silent) with
``sub_rate``, an insertion after the base with ``ins_rate`` and a deletion of
the base and those after it with ``del_rate``, indel lengths geometric with
``indel_geom_p``; about half the reads reverse-complemented.  One departure,
for speed: an event that falls inside a deletion is dropped, and a deletion
that falls inside another still extends it (the original's loop skips the
second deletion).  The draws differ from the original's; the profile is
the same.

The pool's multiset of fragment lengths is the same for every seed (the
traffic file fixes it); the seed draws the order, the positions, the errors
and the strands.
"""

from __future__ import annotations

import importlib.util
import os
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

GENOMES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "genomes")

BASES = np.frombuffer(b"CATG", dtype=np.uint8)
COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ATGC", b"TACG"):
    COMP[_a] = _b


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the seed (the genome, the
    pool, the sample), so that adding a use moves no other."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def random_genome(n: int, rng: np.random.Generator) -> np.ndarray:
    return BASES[rng.integers(0, 4, n)]


def make_genome(gcfg: dict, seed: int) -> np.ndarray:
    """The configuration's genome for ``seed``: ``gcfg["length"]`` bases
    from ``genomes/<gcfg["generator"]>.py`` with ``gcfg["params"]``."""
    name = gcfg["generator"]
    path = os.path.join(GENOMES, name + ".py")
    spec = importlib.util.spec_from_file_location("bm_genome_" + name, path)
    if spec is None or not os.path.exists(path):
        raise ValueError(f"no genome generator at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(int(gcfg["length"]), rng_for(seed, 0),
                    **gcfg.get("params", {}))


def class_lengths(c: dict, k: int) -> np.ndarray:
    """``k`` lengths of one ``classes`` entry, a fixed multiset: spread
    evenly over [lo, hi], or with ``"dist": "lognormal"`` the quantiles of
    a log-normal of ``median`` and ``sigma`` (of the log) truncated to
    [lo, hi], at evenly spaced probabilities."""
    lo, hi = int(c["lo"]), int(c["hi"])
    if c.get("dist", "even") == "even":
        return np.rint(np.linspace(lo, hi, k)).astype(np.int64)
    if c["dist"] != "lognormal":
        raise ValueError(f"no length distribution {c['dist']!r}")
    z = NormalDist()
    mu, sigma = np.log(float(c["median"])), float(c["sigma"])
    p_lo, p_hi = (z.cdf((np.log(v) - mu) / sigma) for v in (lo, hi))
    p = p_lo + (p_hi - p_lo) * (np.arange(k) + 0.5) / max(k, 1)
    q = np.array([z.inv_cdf(float(x)) for x in p])
    return np.clip(np.rint(np.exp(mu + sigma * q)), lo, hi).astype(np.int64)


def pool_lengths(traffic: dict) -> np.ndarray:
    """The fragment lengths of a traffic's pool, in a fixed order: each
    ``classes`` entry gives ``share`` of ``pool_reads`` reads
    (``class_lengths``); the last class takes what rounding leaves."""
    n = int(traffic["pool_reads"])
    classes = traffic["classes"]
    out = []
    for c_i, c in enumerate(classes):
        k = (n - sum(len(o) for o in out) if c_i == len(classes) - 1
             else int(round(n * float(c["share"]))))
        out.append(class_lengths(c, k))
    return np.concatenate(out)


def mutate_many(frags: List[np.ndarray], rng: np.random.Generator,
                sub_rate: float, ins_rate: float, del_rate: float,
                geom_p: float) -> List[np.ndarray]:
    """The ONT error profile applied to every fragment at once; after the
    one draw a base, the work is on the events alone."""
    lens = np.array([len(f) for f in frags], np.int64)
    total = int(lens.sum())
    if not total:
        return [f[:0] for f in frags]
    flat = np.concatenate(frags)
    ends = np.cumsum(lens)
    r = rng.random(total)
    pos = np.flatnonzero(r < sub_rate + ins_rate + del_rate)
    kind = r[pos]
    # Deletions drop [e, e + len), clipped to their own read.
    d_pos = pos[kind >= sub_rate + ins_rate]
    d_end = np.minimum(d_pos + rng.geometric(geom_p, len(d_pos)),
                       ends[np.searchsorted(ends, d_pos, side="right")])
    span = d_end - d_pos
    gone = np.unique(np.repeat(d_pos, span) + np.arange(int(span.sum()))
                     - np.repeat(np.cumsum(span) - span, span))
    keep = np.ones(total, bool)
    keep[gone] = False

    def rank(i):
        """Where kept base i lands among the kept: i less the bases
        dropped before it."""
        return i - np.searchsorted(gone, i, side="left")

    sub = pos[(kind < sub_rate) & keep[pos]]
    ins = pos[(kind >= sub_rate) & (kind < sub_rate + ins_rate) & keep[pos]]
    out = flat[keep]
    out[rank(sub)] = BASES[rng.integers(0, 4, len(sub))]
    ins_len = rng.geometric(geom_p, len(ins))
    n_ins = int(ins_len.sum())
    out = np.insert(out, np.repeat(rank(ins) + 1, ins_len),
                    BASES[rng.integers(0, 4, n_ins)])
    # Each read's first base, moved by what was dropped and inserted
    # before it.
    starts = ends - lens
    ins_before = np.concatenate([[0], np.cumsum(ins_len)])[
        np.searchsorted(ins, starts, side="left")]
    new = rank(starts) + ins_before
    bounds = np.concatenate([new, [len(out)]])
    return [out[bounds[i]:bounds[i + 1]] for i in range(len(frags))]


def make_pool(genome: np.ndarray, traffic: dict,
              rng: np.random.Generator) -> List[Tuple[int, str]]:
    """(fragment length, read) of every pool read, in the seed's order."""
    lengths = pool_lengths(traffic)
    lengths = lengths[rng.permutation(len(lengths))]
    err = traffic["errors"]
    starts = rng.integers(0, np.maximum(1, len(genome) - lengths))
    frags = [genome[s:s + ln] for s, ln in zip(starts.tolist(),
                                               lengths.tolist())]
    reads = mutate_many(frags, rng, float(err["sub_rate"]),
                        float(err["ins_rate"]), float(err["del_rate"]),
                        float(err["indel_geom_p"]))
    flip = rng.random(len(reads)) < float(err["rc_prob"])
    out = []
    for ln, rd, fl in zip(lengths.tolist(), reads, flip.tolist()):
        if fl:
            rd = COMP[rd[::-1]]
        out.append((ln, rd.tobytes().decode("latin1")))
    return out
