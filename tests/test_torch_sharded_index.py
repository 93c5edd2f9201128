"""The port's hash-range-sharded index (pipeline/device_map.
sharded_device_index_from_host, ops/match.find_matches_combined_sharded,
parallel/shard.shard_index, pipeline/mapper._index_shard_count) against
the JAX package's (tests/test_sharded_index.py is the model) and against
the port's replicated layout, on the CPU at k = 9, w = 3 on repeat genomes
(at k = 15 every shard's directory is 2^30 / N entries).

* The packer's arrays equal the JAX packer's ``[d]`` slices for 2, 4 and 8
  shards; its refusals are the JAX package's.
* The sharded lookup equals the port's replicated lookup and the JAX
  package's sharded lookup (under ``shard_map`` on the 8 virtual devices of
  tests/conftest.py) exactly, at budget 512 and at the budget-64 overflow
  case; ``map_step`` / ``map_step_cigar`` over shards equal the replicated
  ones and the JAX package's sharded step.
* ``_index_shard_count`` answers as the JAX mapper's does for every
  ``BIOINFO1_INDEX_SHARD`` value and entry count 1-8 (on stubs).
* ``Mapper(devices=[cpu] * 4)`` under ``BIOINFO1_INDEX_SHARD=1``, and under
  ``auto`` with ``BIOINFO1_INDEX_BUDGET=1000``, prints the JAX mapper's
  lines, score-only and ``-c -a local``, through the sharded lookup.

The port's CPU work runs on a worker thread, as the mapper runs its
batches: torch's CPU ops on the main thread run ~10x slower beside other
busy processes.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bioinfo1_tpu.index import builder as jbuilder
from bioinfo1_tpu.ops import match as jmatch
from bioinfo1_tpu.parallel import shard as jps
from bioinfo1_tpu.pipeline import device_map as jdm
from bioinfo1_tpu.pipeline import mapper as jmapper
from bioinfo1_tpu.utils import simulate as jsim
from bioinfo1_tpu_torch.ops import match as match_ops
from bioinfo1_tpu_torch.ops import minimizer as mz
from bioinfo1_tpu_torch.parallel import shard as ps
from bioinfo1_tpu_torch.pipeline import device_map as dm
from bioinfo1_tpu_torch.pipeline import mapper as tmapper

CPU = torch.device("cpu")
K, W = 9, 3
FIELDS = ("mapped", "is_fwd", "q_begin", "q_end", "t_begin", "t_end",
          "score", "overflow")


def _on_worker(fn, *args):
    with ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args).result()


def _genome(n, rng, tandem_loci=6):
    return jsim.repeat_genome(n, rng, is_elements=6, is_len=400,
                              rrn_operons=2, rrn_len=1000,
                              tandem_loci=tandem_loci, tandem_unit=60,
                              tandem_copies=5)


def _problem(seed, n_reads=16, read_len=512):
    """tests/test_sharded_index.py's problem: the index, a (B, 1024) read
    batch and its lengths."""
    rng = np.random.default_rng(seed)
    genome = _genome(20000, rng)
    index = jbuilder.build_index(genome.tobytes().decode("latin1"), K, W,
                                 0.001)
    recs = jsim.simulate_reads(genome, [read_len] * n_reads, rng)
    reads = np.zeros((n_reads, 1024), np.uint8)
    lens = np.zeros(n_reads, np.int32)
    for i, (_, s) in enumerate(recs):
        reads[i, :len(s)] = np.frombuffer(s.encode("latin1"), np.uint8)
        lens[i] = len(s)
    return index, reads, lens


@pytest.fixture(scope="module")
def problems():
    return {seed: _problem(seed) for seed in (3, 11)}


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_packer_matches_jax(problems, n_shards):
    index = problems[3][0]
    want = jdm.sharded_device_index_from_host(index, n_shards)
    got = dm.sharded_device_index_from_host(index, n_shards,
                                            [CPU] * n_shards)
    S = (1 << (2 * K)) // n_shards
    assert len(got) == n_shards and want.shard_range == S
    for d, shard in enumerate(got):
        assert (shard.shard_range, shard.cnt_shift, shard.shift,
                shard.bsearch_steps) == (S, want.cnt_shift, 0, 0)
        assert shard.bucket_off.shape == (S + 1,)
        for f in ("key_hash", "key_pos", "cnt_fr", "cnt_r2", "bucket_off"):
            w_ = np.asarray(jax.device_get(getattr(want, f)))[d]
            g = getattr(shard, f).numpy()
            np.testing.assert_array_equal(g, w_.astype(g.dtype),
                                          err_msg=f"{f}[{d}]")
        np.testing.assert_array_equal(
            shard.ref_bytes.numpy(), np.asarray(want.ref_bytes))
        assert shard.ref_bytes is got[0].ref_bytes    # one copy a device


def test_sharded_packer_refusals(problems):
    index = problems[3][0]
    with pytest.raises(ValueError, match="must divide the hash space"):
        dm.sharded_device_index_from_host(index, 3, [CPU] * 3)
    big = types.SimpleNamespace(k=16)
    with pytest.raises(ValueError, match="needs 2\\*k <= 30"):
        dm.sharded_device_index_from_host(big, 2, [CPU] * 2)


def _queries(reads, lens):
    mres = mz.minimize_batch(torch.from_numpy(reads), torch.from_numpy(lens),
                             K, W)
    return match_ops.compact_queries(mres.hashes, mres.pos,
                                     mres.dedup_keep, 512)[:3]


def _jax_sharded_lookup(index, q_hash, q_pos, q_keep, n_shards, budget):
    """The JAX package's lookup over ``n_shards`` virtual devices, queries
    split by rows as its mapper splits a batch."""
    shd = jdm.sharded_device_index_from_host(index, n_shards)

    def local(qh, qp, kp, kh, kpos, cf, c2, bo):
        return jmatch.find_matches_combined_sharded(
            qh, qp, kp, kh[0], kpos[0], cf[0], c2[0], bo[0],
            shd.shard_range, budget, shd.cnt_shift, "data")

    fn = jax.jit(jax.shard_map(
        local, mesh=jps.make_mesh(n_shards),
        in_specs=(P("data"),) * 3 + (P("data", None),) * 5,
        out_specs=P("data"), check_vma=False))
    out = fn(jnp.asarray(q_hash.numpy().astype(np.uint32)),
             jnp.asarray(q_pos.numpy()), jnp.asarray(q_keep.numpy()),
             shd.key_hash, shd.key_pos, shd.cnt_fr, shd.cnt_r2,
             shd.bucket_off)
    return jax.device_get(out)


@pytest.mark.parametrize("seed,budget", [(3, 512), (11, 64)],
                         ids=["budget512", "overflow_budget64"])
def test_sharded_lookup_matches_replicated_and_jax(problems, seed, budget):
    """Every Matches field, both strands: the port's sharded lookup over 2,
    4 and 8 shards against its replicated lookup, and over 8 against the
    JAX package's sharded lookup.  Budget 64 on the repeat-heavy problem
    overflows reads: count, total and overflow feed the budget ladder."""
    index, reads, lens = problems[seed]
    q_hash, q_pos, q_keep = _queries(reads, lens)
    rep = dm.device_index_from_host(index, CPU)
    want = match_ops.find_matches_combined(
        q_hash, q_pos, q_keep, rep.key_hash, rep.key_pos, rep.cnt_fr,
        rep.cnt_r2, rep.bucket_off, rep.shift, rep.bsearch_steps, budget,
        rep.cnt_shift)
    if budget == 64:
        assert bool((want[0].overflow | want[1].overflow).any())
    table = np.concatenate([index.fwd.hash_sorted, index.rev.hash_sorted])
    n_found = int(np.isin(q_hash.numpy()[q_keep.numpy()], table).sum())
    for n in (2, 4, 8):
        shards = dm.sharded_device_index_from_host(index, n, [CPU] * n)
        served = [torch.zeros((), dtype=torch.int64) for _ in range(n)]
        got = _on_worker(lambda: match_ops.find_matches_combined_sharded(
            q_hash, q_pos, q_keep, shards, shards[0].shard_range, budget,
            shards[0].cnt_shift, served=served))
        for strand, g, w_ in zip("fr", got, want):
            for f in ("f_pos", "r_pos", "count", "total", "overflow"):
                assert torch.equal(getattr(g, f), getattr(w_, f)), \
                    (n, strand, f)
        # Each shard counts the query slots it found: together, every kept
        # slot whose hash the table holds, once.
        assert sum(int(s) for s in served) == n_found
        assert sum(int(s) > 0 for s in served) >= 2
    jax_got = _jax_sharded_lookup(index, q_hash, q_pos, q_keep, 8, budget)
    for strand, g, j in zip("fr", got, jax_got):
        for f in ("f_pos", "r_pos", "count", "total", "overflow"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f"{strand} {f}")


def _sharded(index, n):
    return ps.shard_index(index, ps.DeviceSet([CPU] * n))[CPU]


@pytest.mark.parametrize("cigar", [False, True], ids=["score", "c"])
def test_sharded_map_step_matches_replicated_and_jax(problems, cigar):
    """``map_step`` (global, band 0) and ``map_step_cigar`` (band 128) over
    8 shards: every field equal to the replicated step's and to the JAX
    package's sharded step on the 8-device mesh."""
    index, reads, lens = problems[3]
    if cigar:
        reads, lens = reads[:8], lens[:8]
    kw = dict(k=K, w=W, mode=0, budget=512, region_cap=reads.shape[1])
    if cigar:
        kw["band"] = 128
    step = dm.map_step_cigar if cigar else dm.map_step
    r, ln = torch.from_numpy(reads), torch.from_numpy(lens)
    rep = dm.device_index_from_host(index, CPU)
    shd = _sharded(index, 8)
    want, got = _on_worker(lambda: [
        step(r, ln, idx, 1, -1, -1, **kw).to_numpy() for idx in (rep, shd)])
    assert sum(int(s) for s in shd.served) > 0
    mesh = jps.make_mesh(8)
    jshd = jdm.sharded_device_index_from_host(index, 8)
    make = jps.sharded_map_step_cigar if cigar else jps.sharded_map_step
    jstep = make(mesh, **kw, index_specs=jps._index_specs(jshd))
    jout = jax.device_get(jstep(jnp.asarray(reads), jnp.asarray(lens),
                                jps.shard_index(jshd, mesh), jnp.int32(1),
                                jnp.int32(-1), jnp.int32(-1)))
    base = (lambda o: o.base) if cigar else (lambda o: o)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(base(got), f),
                                      getattr(base(want), f), err_msg=f)
        np.testing.assert_array_equal(getattr(base(got), f),
                                      np.asarray(getattr(base(jout), f)),
                                      err_msg=f"jax {f}")
    if cigar:
        for f in ("codes", "goal_i", "goal_j", "certified"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
            np.testing.assert_array_equal(
                getattr(got, f), np.asarray(getattr(jout, f)),
                err_msg=f"jax {f}")
    assert base(got).mapped.sum() >= 6


class _Entries:
    """len() of a strand index's entry list without the entries."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("mode", [None, "0", "false", "off", "1", "true",
                                  "on", "auto", "force", ""])
def test_index_shard_count_matches_jax(monkeypatch, mode):
    """Every entry count 1-8, at k = 15 (directory term) and k = 16 (too
    many hash bits), small and large indexes, default and tiny budgets."""
    if mode is None:
        monkeypatch.delenv("BIOINFO1_INDEX_SHARD", raising=False)
    else:
        monkeypatch.setenv("BIOINFO1_INDEX_SHARD", mode)
    seen = set()
    for budget in (None, "1000", "5e9"):
        if budget is None:
            monkeypatch.delenv("BIOINFO1_INDEX_BUDGET", raising=False)
        else:
            monkeypatch.setenv("BIOINFO1_INDEX_BUDGET", budget)
        for k in (9, 15, 16):
            for n_entries in (1000, (1 << 20) - 1, 1 << 20, 200_000_000):
                stub = types.SimpleNamespace(
                    cfg=types.SimpleNamespace(k=k),
                    index=types.SimpleNamespace(
                        fwd=types.SimpleNamespace(
                            hash_sorted=_Entries(n_entries // 2)),
                        rev=types.SimpleNamespace(
                            hash_sorted=_Entries(n_entries - n_entries // 2
                                                 ))))
                for n_dev in range(1, 9):
                    mesh = (None if n_dev == 1
                            else types.SimpleNamespace(size=n_dev))
                    want = jmapper.Mapper._index_shard_count(stub, mesh)
                    got = tmapper._index_shard_count(k, n_entries, n_dev)
                    assert got == want, (mode, budget, k, n_entries, n_dev)
                    seen.add(got)
    assert 0 in seen
    if mode in ("1", "true", "on"):
        assert seen == {0, 2, 4, 8}


@pytest.fixture(scope="module")
def mapper_problem():
    """A repeat genome, 12 reads of 300 bases, and the JAX mapper's lines
    for each kind (replicated on its 8-device mesh)."""
    rng = np.random.default_rng(5)
    genome = _genome(30000, rng, tandem_loci=8)
    refs = [("ref", genome.tobytes().decode("latin1"))]
    recs = jsim.simulate_reads(genome, [300] * 12, rng)
    want = {kind: jmapper.Mapper(refs, jmapper.MapperConfig(**kw))
            .map_records(recs) for kind, kw in _KINDS.items()}
    return refs, recs, want


_KINDS = {"score": dict(k=K, w=W, batch_size=4),
          "c_local": dict(k=K, w=W, batch_size=4, align_type="local",
                          output_cigar=True)}


@pytest.mark.parametrize("env", [{"BIOINFO1_INDEX_SHARD": "1"},
                                 {"BIOINFO1_INDEX_SHARD": "auto",
                                  "BIOINFO1_INDEX_BUDGET": "1000"}],
                         ids=["shard1", "auto_budget1000"])
@pytest.mark.parametrize("kind", list(_KINDS))
def test_sharded_mapper_matches_jax(mapper_problem, monkeypatch, env, kind):
    refs, recs, want = mapper_problem
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    mapper = tmapper.Mapper(refs, tmapper.MapperConfig(**_KINDS[kind]),
                            devices=[CPU] * 4)
    got = _on_worker(mapper.map_records, recs)
    assert got == want[kind]
    assert sum(1 for line in got if "\t" in line) >= 10
    index = mapper.device_index()
    assert isinstance(index, dm.ShardedIndex), "sharded path not taken"
    assert len(index.shards) == 4 and len(mapper._device_index) == 1
    served = [int(s) for s in index.served]
    assert min(served[:3]) > 0, served
    assert mapper.counters.faults == 0 and mapper.counters.budget_retries
