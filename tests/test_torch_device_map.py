"""Port's fused map step against the JAX package's, field for field.

The same index (the JAX DeviceIndex's arrays, handed to the port with
``device_index_from_numpy``) and the same read batch go through both
``map_step``s: the JAX one with ``use_pallas=False`` and with
``use_pallas=True`` under the Pallas TPU interpreter, at band 0 (full
score) and 256 (banded score + certificate), in all three modes.  Every
MapOut field must be equal.  The packed index itself must equal JAX's in
both directory modes.  ``map_step_cigar`` (band 256, all three modes)
against the JAX one the same two ways: equal MapOut fields, the same
strict certificate as the Pallas route, and equal CIGARs on every read
both certify (the lax route rounds its band to 16 lanes, so its
certificate may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bioinfo1_tpu import native
from bioinfo1_tpu.index import builder
from bioinfo1_tpu.pipeline import device_map as jdm
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch.pipeline import device_map as tdm

K, W = 11, 5
CPU = torch.device("cpu")
FIELDS = ("mapped", "is_fwd", "q_begin", "q_end", "t_begin", "t_end",
          "score", "overflow", "need", "inexact")


def _arrays(didx):
    return {f: np.asarray(jax.device_get(getattr(didx, f))) for f in
            ("key_hash", "key_pos", "cnt_fr", "cnt_r2", "bucket_off",
             "ref_bytes", "ref_len")}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(2024)
    genome = simulate.random_genome(30000, rng)
    gstr = genome.tobytes().decode("latin1")
    index = builder.build_index(gstr, K, W, 0.0)
    jidx = jdm.device_index_from_host(index)
    # ONT-like reads (both strands), one with a 400-base deletion (drifts
    # off the band: certificate miss), one junk read.
    recs = simulate.simulate_reads(
        genome, rng.integers(150, 480, 10), rng)
    seqs = [s for _, s in recs]
    s0 = int(rng.integers(0, 25000))
    seqs.append(gstr[s0:s0 + 150] + gstr[s0 + 550:s0 + 850])
    seqs.append(simulate.random_genome(300, rng).tobytes().decode("latin1"))
    L = 512
    arr = np.zeros((len(seqs), L), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        arr[i, :len(s)] = np.frombuffer(s.encode("latin1"), np.uint8)
        lens[i] = len(s)
    return index, jidx, arr, lens


@pytest.mark.parametrize("direct", [False, True])
def test_device_index_matches_jax(direct, monkeypatch):
    monkeypatch.setenv("BIOINFO1_DIRECT_INDEX", "1" if direct else "0")
    rng = np.random.default_rng(5)
    gstr = simulate.random_genome(20000, rng).tobytes().decode("latin1")
    index = builder.build_index(gstr, 10, 5, 0.001)
    want = jdm.device_index_from_host(index)
    got = tdm.device_index_from_host(index, CPU)
    assert (got.shift, got.bsearch_steps, got.cnt_shift) == (
        want.shift, want.bsearch_steps, want.cnt_shift)
    assert (got.bsearch_steps == 0) == direct
    for f, w_ in _arrays(want).items():
        g = getattr(got, f)
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, w_.astype(np.asarray(g).dtype),
                                      err_msg=f)


@pytest.mark.parametrize("band", [0, 256])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_map_step_matches_jax(problem, mode, band):
    index, jidx, arr, lens = problem
    kw = dict(k=K, w=W, mode=mode, budget=512, region_cap=1024, band=band)
    scoring = (1, -1, -1)
    tidx = tdm.device_index_from_numpy(_arrays(jidx), jidx.shift,
                                       jidx.bsearch_steps, jidx.cnt_shift,
                                       CPU)
    got = tdm.map_step(torch.from_numpy(arr), torch.from_numpy(lens), tidx,
                       *scoring, **kw).to_numpy()
    assert got.mapped.sum() >= 8
    if band:
        assert got.inexact.any()
    jscoring = tuple(jnp.int32(x) for x in scoring)
    want_lax = jax.device_get(jdm.map_step(
        jnp.asarray(arr), jnp.asarray(lens), jidx, *jscoring, **kw))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jax.device_get(jdm.map_step(
            jnp.asarray(arr), jnp.asarray(lens), jidx, *jscoring,
            use_pallas=True, **kw))
    for want in (want_lax, want_pallas):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)


def _cigars(out, mode, n):
    """CIGARs of the first n reads decoded from a CigarOut's packed codes
    (either walk's layout: the decoder skips code 3)."""
    idx = np.arange(n, dtype=np.int32)
    name = ("global", "local", "semiGlobal")[mode]
    return native.cigar_rle_batch(
        np.asarray(out.codes), idx, *(np.asarray(getattr(out, f))[:n] for f
                                      in ("goal_i", "goal_j", "q_len",
                                          "t_len")), name)[0]


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_map_step_cigar_matches_jax(problem, mode):
    index, jidx, arr, lens = problem
    kw = dict(k=K, w=W, mode=mode, budget=512, region_cap=1024, band=256)
    scoring = (1, -1, -1)
    tidx = tdm.device_index_from_numpy(_arrays(jidx), jidx.shift,
                                       jidx.bsearch_steps, jidx.cnt_shift,
                                       CPU)
    got = tdm.map_step_cigar(torch.from_numpy(arr), torch.from_numpy(lens),
                             tidx, *scoring, **kw).to_numpy()
    n = len(lens)
    mapped = got.base.mapped
    assert mapped.sum() >= 8 and not got.base.inexact.any()
    assert (mapped & ~got.certified).any()      # the deletion read misses
    cig_got = _cigars(got, mode, n)
    jscoring = tuple(jnp.int32(x) for x in scoring)
    want_lax = jax.device_get(jdm.map_step_cigar(
        jnp.asarray(arr), jnp.asarray(lens), jidx, *jscoring, **kw))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jax.device_get(jdm.map_step_cigar(
            jnp.asarray(arr), jnp.asarray(lens), jidx, *jscoring,
            use_pallas=True, **kw))
    np.testing.assert_array_equal(got.certified,
                                  np.asarray(want_pallas.certified))
    for want in (want_lax, want_pallas):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(got.base, f), np.asarray(getattr(want.base, f)),
                err_msg=f)
        for f in ("goal_i", "goal_j", "q_len", "t_len"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))
        both = mapped & got.certified & np.asarray(want.certified)
        assert both.sum() >= mapped.sum() - 2
        cig_want = _cigars(want, mode, n)
        for b in np.flatnonzero(both):
            assert cig_got[b] == cig_want[b], b
