"""The staged host path of the port against the JAX package, exactly.

* ``ops/match.find_matches`` and ``hash_present`` against their JAX
  counterparts (budget overflow, empty index, an all-dropped ``keep``).
* ``Mapper._map_bucket`` against the JAX ``_map_bucket``, ReadMapping by
  ReadMapping and retry list by retry list: score-only, ``-c`` with a
  certificate (banded, then the needed-band retry), ``-c`` without one in
  each mode, FASTA match nesting, and a budget small enough to overflow.
* The design the port takes where the JAX package runs its full-matrix
  wavefront with parents: the banded kernel at a band that covers the whole
  matrix, then the walk.  Scores, goal cells and CIGARs must equal
  ``align_batch(want_parents=True)`` + ``walk_parents(band=0)`` on inputs
  with many ties: gap 0 and gap +1, a two-letter alphabet, '-' bytes,
  1-wide and 1-tall regions, NUL-padded regions, in all three modes.
* A read forced to the host route after two fused attempts (its chain
  spans more target than the fused step's region cap) gives the JAX
  package's ReadMapping.

The torch side runs on the CPU (plain versions).  Tolerance: exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.ops import align as jal
from bioinfo1_tpu.ops import match as jmatch
from bioinfo1_tpu.ops import trace as jtr
from bioinfo1_tpu.pipeline import mapper as jmapper
from bioinfo1_tpu.utils import cigar as cg
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch.ops import band as tband
from bioinfo1_tpu_torch.ops import match as tmatch
from bioinfo1_tpu_torch.ops import trace as ttr
from bioinfo1_tpu_torch.pipeline import mapper as tmapper

CPU = torch.device("cpu")
MODE_NAMES = {0: "global", 1: "local", 2: "semiGlobal"}


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- find_matches / hash_present -----------------------------------------

def _lookup_inputs(seed, U=400, B=5, T=48, n_hash=60):
    rng = np.random.default_rng(seed)
    idx_hash = rng.integers(0, n_hash, U).astype(np.uint32)
    idx_pos = rng.integers(1, 5000, U).astype(np.int32)
    order = np.lexsort((idx_pos, idx_hash))
    idx_hash, idx_pos = idx_hash[order], idx_pos[order]
    min_hash = rng.integers(0, n_hash + 10, (B, T)).astype(np.uint32)
    min_pos = np.sort(rng.integers(1, 3000, (B, T)), axis=1).astype(np.int32)
    keep = rng.random((B, T)) < 0.7
    keep[1] = False                       # every slot dropped
    return idx_hash, idx_pos, min_hash, min_pos, keep


def _assert_matches_equal(got, want):
    for f in ("f_pos", "r_pos", "count", "total", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("budget", [16, 64, 1024])
def test_find_matches_equals_jax(budget):
    idx_hash, idx_pos, min_hash, min_pos, keep = _lookup_inputs(budget)
    want = jmatch.find_matches(min_hash, min_pos, keep, idx_hash, idx_pos,
                               budget)
    got = tmatch.find_matches(_t(min_hash.astype(np.int64)), _t(min_pos),
                              _t(keep), _t(idx_hash.astype(np.int64)),
                              _t(idx_pos), budget)
    _assert_matches_equal(got, want)
    assert bool(got.overflow.any()) == (budget < 1024)
    assert int(got.total[1]) == 0


def test_find_matches_and_hash_present_empty_index():
    _, _, min_hash, min_pos, keep = _lookup_inputs(3)
    e_h, e_p = np.zeros(0, np.uint32), np.zeros(0, np.int32)
    want = jmatch.find_matches(min_hash, min_pos, keep, e_h, e_p, 32)
    got = tmatch.find_matches(_t(min_hash.astype(np.int64)), _t(min_pos),
                              _t(keep), _t(e_h.astype(np.int64)), _t(e_p), 32)
    _assert_matches_equal(got, want)
    present = tmatch.hash_present(_t(e_h.astype(np.int64)),
                                  _t(min_hash.astype(np.int64)))
    np.testing.assert_array_equal(present.numpy(),
                                  _np(jmatch.hash_present(e_h, min_hash)))


def test_hash_present_equals_jax():
    idx_hash, _, min_hash, _, _ = _lookup_inputs(9)
    min_hash[0, :4] = [0, idx_hash[-1], idx_hash[-1] + 1, 0xFFFFFFFF]
    got = tmatch.hash_present(_t(idx_hash.astype(np.int64)),
                              _t(min_hash.astype(np.int64)))
    want = _np(jmatch.hash_present(idx_hash, min_hash))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


# ---- _map_bucket ----------------------------------------------------------

@pytest.fixture(scope="module")
def genome_reads():
    rng = np.random.default_rng(77)
    genome = simulate.repeat_genome(24000, rng, is_elements=6, is_len=250,
                                    rrn_operons=3, rrn_len=500,
                                    tandem_loci=4, tandem_unit=30,
                                    tandem_copies=5)
    gstr = genome.tobytes().decode("latin1")
    recs = simulate.simulate_reads(genome, [120, 260, 420, 640, 900], rng)
    recs += simulate.simulate_reads(genome, [700], rng, sub_rate=0.01,
                                    ins_rate=0.0, del_rate=0.0)
    s0 = 9000
    seqs = [s for _, s in recs]
    seqs.append(gstr[s0:s0 + 400] + gstr[s0 + 520:s0 + 900])   # 120 deleted
    # 300 deleted: misses the band-256 certificate; one retry certifies.
    seqs.append(gstr[s0 + 2000:s0 + 2450] + gstr[s0 + 2750:s0 + 3200])
    seqs.append(gstr[3000:3300] + "-" * 2 + gstr[3300:3500])   # '-' bytes
    seqs.append("ACGT" * 40)                                   # no chain
    return gstr, seqs


def _mappers(gstr, **cfg_kw):
    jm = jmapper.Mapper([("chr", gstr)], jmapper.MapperConfig(**cfg_kw))
    tm = tmapper.Mapper([("chr", gstr)], tmapper.MapperConfig(**cfg_kw),
                        device=CPU)
    return jm, tm


def _assert_mappings_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert dataclasses.asdict(g) == dataclasses.asdict(w), i


BUG = dict(banned_rev_from_fwd=True, fasta_match_nesting=True,
           local_target_begin_end=True, threshold_from_rev_unique=True,
           exact_ties=True, oob_end_windows=True)


@pytest.mark.parametrize("cfg_kw,budget", [
    (dict(), 512),
    (dict(align_type="local"), 512),
    (dict(align_type="semiGlobal"), 32),            # overflow retries
    (dict(output_cigar=True), 512),                 # certificate: banded
    (dict(output_cigar=True, align_type="local", gap=0), 512),
    (dict(output_cigar=True, gap=1), 512),          # no certificate
    (dict(output_cigar=True, gap=0), 512),
    (dict(output_cigar=True, align_type="local", gap=1), 512),
    (dict(output_cigar=True, align_type="semiGlobal", gap=1), 512),
    (dict(BUG), 512),                               # FASTA match nesting
    (dict(BUG, output_cigar=True, align_type="local"), 512),
], ids=["score", "score_local", "score_semi_overflow", "c_cert",
        "c_cert_local_g0", "c_g1", "c_g0", "c_local_g1", "c_semi_g1",
        "nesting", "nesting_c_local"])
def test_map_bucket_equals_jax(genome_reads, cfg_kw, budget):
    gstr, seqs = genome_reads
    if cfg_kw == dict(output_cigar=True):
        # A '-' byte rules the global certificate out for its whole group.
        seqs = [s for s in seqs if "-" not in s]
    jm, tm = _mappers(gstr, **cfg_kw)
    want, want_retry = jmapper._map_bucket(seqs, jm.index, jm.cfg, budget)
    bands = []
    banded_pass = tm._banded_pass
    tm._banded_pass = lambda qa, ql, ta, tl, W, *a, **kw: (
        bands.append(W), banded_pass(qa, ql, ta, tl, W, *a, **kw))[1]
    got, got_retry = tm._map_bucket(seqs, budget)
    assert got_retry == want_retry
    if cfg_kw == dict(output_cigar=True):
        assert bands == [256, 1024]     # the needed-band retry ran
    elif cfg_kw.get("gap", -1) > 0:
        assert bands == [1280]          # straight to the whole matrix
    _assert_mappings_equal(got, want)
    assert sum(r.mapped for r in got) >= 3
    if budget == 32:
        assert got_retry
    if cfg_kw.get("output_cigar"):
        assert all(r.cigar for r in got if r.mapped)


def test_map_bucket_band_hint_equals_jax(genome_reads):
    gstr, seqs = genome_reads
    jm, tm = _mappers(gstr, output_cigar=True)
    want, _ = jmapper._map_bucket(seqs, jm.index, jm.cfg, 512, band_hint=300)
    got, _ = tm._map_bucket(seqs, 512, band_hint=300)
    _assert_mappings_equal(got, want)


# ---- whole-matrix band against the full-matrix wavefront ------------------

def _tie_pairs(seed, B=12, n=48, m=64, alphabet=b"AC"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = rng.integers(2, n + 1, B).astype(np.int32)
    tl = rng.integers(2, m + 1, B).astype(np.int32)
    ql[0], tl[0] = 1, m               # 1-tall
    ql[1], tl[1] = n, 1               # 1-wide
    ql[2], tl[2] = 1, 1
    ql[3], tl[3] = n, m
    for b in range(B):
        qa[b, :ql[b]] = letters[rng.integers(0, len(letters), ql[b])]
        ta[b, :tl[b]] = letters[rng.integers(0, len(letters), tl[b])]
    for b in (4, 5, 6):                      # literal '-' bytes
        qa[b, rng.integers(0, ql[b], 2)] = ord("-")
        ta[b, rng.integers(0, tl[b], 2)] = ord("-")
    for b in (7, 8):                         # NUL-padded regions
        qa[b, ql[b] - min(3, ql[b] - 1):ql[b]] = 0
        ta[b, tl[b] - min(5, tl[b] - 1):tl[b]] = 0
    ta[9, :tl[9]] = qa[9, 0]                 # one letter: every path ties
    qa[9, :ql[9]] = qa[9, 0]
    return qa, ql, ta, tl


def _cigars(codes, mode, gi, gj, ql, tl):
    return [cg.cigar_from_codes(codes[:, b], MODE_NAMES[mode], int(gi[b]),
                                int(gj[b]), int(ql[b]), int(tl[b]))
            for b in range(len(ql))]


@pytest.mark.parametrize("scoring", [(1, -1, 0), (1, -1, 1), (2, 0, -1),
                                     (0, 0, 0)],
                         ids=["g0", "g1", "m2n0", "zeros"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_whole_matrix_band_equals_full_wavefront(mode, scoring):
    qa, ql, ta, tl = _tie_pairs(100 * mode + sum(scoring))
    want = jax.device_get(jal.align_batch(qa, ql, ta, tl, mode, *scoring,
                                          want_parents=True))
    want_codes = _np(jtr.walk_parents(
        want.parents, want.goal_i, want.goal_j, want.score, qa, ta,
        *scoring, mode=mode, band=0))
    W = -(-max(int(ql.max()), int(tl.max()) + 2) // 128) * 128
    q, qlt, t, tlt = (_t(x) for x in (qa, ql, ta, tl))
    dash_free = not ((qa == 45).any() or (ta == 45).any())
    got = tband.align_scores_banded(q, qlt, t, tlt, *scoring, band=W,
                                    mode=mode, dash_free=dash_free,
                                    want_parents=True)
    assert bool(tband.certify(got.score, q, qlt, t, tlt, *scoring, W,
                              strict=True, mode=mode).all())
    for f in ("score", "goal_i", "goal_j"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    got_codes = ttr.unpack_codes(ttr.walk_parents(
        got.parents, got.goal_i, got.goal_j, got.score, q, t, *scoring,
        mode).numpy())
    assert _cigars(got_codes, mode, want.goal_i, want.goal_j, ql, tl) == \
        _cigars(want_codes, mode, want.goal_i, want.goal_j, ql, tl)


# ---- the host route of map_batch ------------------------------------------

@pytest.mark.parametrize("cigar", [False, True], ids=["score", "c"])
def test_straggler_takes_host_route_like_jax(genome_reads, cigar):
    """A read whose chain spans far more target than the fused step's
    region cap overflows twice, then takes the host route."""
    gstr, seqs = genome_reads
    s0 = 15000
    straggler = gstr[s0:s0 + 300] + gstr[s0 + 2600:s0 + 2900]
    batch = [seqs[2], straggler, seqs[3]]
    jm, tm = _mappers(gstr, output_cigar=cigar)
    want = jm.map_batch(batch)
    got = tm.map_batch(batch)
    _assert_mappings_equal(got, want)
    assert got[1].mapped and got[1].t_end - got[1].t_begin > 2800
    c = tm.counters.as_dict()
    assert c["host_fallbacks"] == 1 and c["t_host_s"] > 0
    assert c["budget_retries"] >= 2
