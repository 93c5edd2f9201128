"""The plain reference: its DP against a cell-by-cell one, and its PAF
rows against the port's on the CPU at a tiny size, for each
configuration."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import simulate
from benchmark.references import mapper as ref
from conftest import DATA


def _dp_brute(q, t, match, mismatch, gap):
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), np.int64)
    H[:, 0] = np.arange(n + 1) * gap
    H[0, :] = np.arange(m + 1) * gap

    def cost(c):
        return 0 if c == ord("-") else gap
    P = np.zeros((n + 1, m + 1), np.int64)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d = H[i - 1, j - 1] + (match if q[i - 1] == t[j - 1] else mismatch)
            left = H[i, j - 1] + cost(t[j - 1])
            up = H[i - 1, j] + cost(q[i - 1])
            H[i, j] = max(d, left, up)
            P[i, j] = 0 if d == H[i, j] else (1 if left == H[i, j] else 2)
    ops, i, j = [], n, m
    while i > 0 or j > 0:
        op = 1 if i == 0 else 2 if j == 0 else P[i, j]
        ops.append("MID"[op])
        i, j = (i - 1, j - 1) if op == 0 else (i, j - 1) if op == 1 \
            else (i - 1, j)
    s = "".join(reversed(ops))
    runs, k = [], 0
    while k < len(s):
        e = k
        while e < len(s) and s[e] == s[k]:
            e += 1
        runs.append(f"{e - k}{s[k]}")
        k = e
    return int(H[n, m]), "".join(runs)


def test_dp_against_cell_by_cell():
    rng = np.random.default_rng(1)
    pairs = []
    for _ in range(12):
        q = simulate.BASES[rng.integers(0, 4, int(rng.integers(1, 40)))]
        t = simulate.BASES[rng.integers(0, 4, int(rng.integers(1, 40)))]
        if rng.random() < 0.3:
            q = q.copy()
            q[int(rng.integers(0, len(q)))] = ord("-")
        pairs.append((q, t))
    got = ref.global_dp(pairs, 1, -1, -1, True, torch.device("cpu"))
    for (q, t), (s, c) in zip(pairs, got):
        assert (s, c) == _dp_brute(q, t, 1, -1, -1)
    got2 = ref.global_dp(pairs, 2, -3, -2, False, torch.device("cpu"))
    assert [s for s, _ in got2] == [_dp_brute(q, t, 2, -3, -2)[0]
                                    for q, t in pairs]


def test_band_restricts_the_dp():
    """The control's band leaves the score where the path stays inside it
    and loses it where the ends drift past it."""
    rng = np.random.default_rng(2)
    t = simulate.BASES[rng.integers(0, 4, 600)]
    inside = (t[:590].copy(), t)                # the goal 10 diagonals off
    outside = (t[:400].copy(), t)               # 200 diagonals off
    full = ref.global_dp([inside, outside], 1, -1, -1, False,
                         torch.device("cpu"))
    band = ref.global_dp([inside, outside], 1, -1, -1, False,
                         torch.device("cpu"), band=128)
    assert band[0] == full[0]
    assert band[1][0] < full[1][0]


def _port_rows(config, genome, reads, devices):
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    os.environ["BIOINFO1_BAND_CACHE"] = "0"
    cfg = MapperConfig(**dict(config["mapper"], batch_size=8))
    m = Mapper([(config["genome"]["name"], genome.tobytes().decode(
        "latin1"))], cfg, devices=devices)
    lines = m.map_records([(k, v.tobytes().decode("latin1"))
                           for k, v in reads.items()])
    return {ln.split("\t", 1)[0]: ln.split("\t", 1)[1] for ln in lines}


@pytest.mark.parametrize("cigar,n_dev,seed", [(False, 1, 9), (True, 1, 10),
                                              (False, 2, 11)])
def test_reference_agrees_with_the_port(cigar, n_dev, seed):
    """On the configuration's genome generator at 40 kb (its repeats
    scaled), with and without -c, on one device and dealt over two."""
    with open(os.path.join(DATA, "configs", "ecoli_paf.json")) as fh:
        conf = json.load(fh)
    conf["mapper"]["output_cigar"] = cigar
    genome = simulate.make_genome(conf["genome"], seed)
    with open(os.path.join(DATA, "traffic", "ont_2_8kb.json")) as fh:
        traffic = json.load(fh)
    traffic["pool_reads"] = 10
    pool = simulate.make_pool(genome, traffic, simulate.rng_for(seed, 1))
    reads = {f"r{i}": np.frombuffer(s.encode("latin1"), np.uint8)
             for i, (_, s) in enumerate(pool)}
    # A read of random bases: no chain on either strand, no row.
    reads["noise"] = simulate.random_genome(300, np.random.default_rng(4))
    m = conf["mapper"]
    want = ref.paf_rows(ref.Reference(conf["genome"]["name"], genome,
                                      m["k"], m["w"], m["f"]),
                        reads, m["match"], m["mismatch"], m["gap"],
                        m["output_cigar"], torch.device("cpu"), 1e8)
    got = _port_rows(conf, genome, reads, [torch.device("cpu")] * n_dev)
    assert want["noise"] is None and "noise" not in got
    assert {k: v for k, v in want.items() if v is not None} == got
    assert sum(v is not None for v in want.values()) >= 8
    if m["output_cigar"]:
        assert all("cg:Z:" in v for v in got.values())


def test_reference_agrees_with_the_port_in_the_repeats():
    """Reads drawn from the planted copies only (IS-like, rRNA-like and
    tandem), where the frequency ban and repeated hits decide the chain."""
    with open(os.path.join(DATA, "configs", "ecoli_paf.json")) as fh:
        conf = json.load(fh)
    gcfg = dict(conf["genome"], length=60_000,
                params=dict(conf["genome"]["params"], is_elements=12,
                            rrn_operons=5, tandem_loci=10))
    genome = simulate.make_genome(gcfg, 2 ** 31 + 3)
    seq = genome.tobytes()
    # Positions whose 15-mer occurs again elsewhere: inside a repeat.
    first = {}
    rep = np.zeros(len(seq), bool)
    for i in range(len(seq) - 14):
        j = first.setdefault(seq[i:i + 15], i)
        if j != i:
            rep[i] = rep[j] = True
    starts = np.flatnonzero(rep[:-1500])
    rng = np.random.default_rng(3)
    pick = starts[rng.choice(len(starts), 10, replace=False)]
    reads = {}
    for n, s in enumerate(pick.tolist()):
        frag = genome[max(0, s - 200):s + 1300]
        reads[f"r{n}"] = simulate.mutate_many([frag], rng, 0.05, 0.03,
                                              0.04, 0.6)[0]
    m = conf["mapper"]
    want = ref.paf_rows(ref.Reference(gcfg["name"], genome, m["k"], m["w"],
                                      m["f"]),
                        reads, m["match"], m["mismatch"], m["gap"], False,
                        torch.device("cpu"), 1e8)
    got = _port_rows(conf, genome, reads, [torch.device("cpu")])
    assert {k: v for k, v in want.items() if v is not None} == got
    assert sum(v is not None for v in want.values()) >= 8
