"""Port ops (encode, minimizer, match) against the JAX package, exactly.

Inputs come from seeded numpy generators and go through both packages;
every compared array must be equal (integers, tolerance 0).  The torch
side runs on the CPU, where it uses its plain versions.
"""

import jax
import numpy as np
import pytest
import torch

from bioinfo1_tpu.index import builder
from bioinfo1_tpu.ops import encode as jenc
from bioinfo1_tpu.ops import match as jmatch
from bioinfo1_tpu.ops import minimizer as jmz
from bioinfo1_tpu.pipeline import device_map as jdm
from bioinfo1_tpu_torch.ops import encode as tenc
from bioinfo1_tpu_torch.ops import match as tmatch
from bioinfo1_tpu_torch.ops import minimizer as tmz
from bioinfo1_tpu_torch.pipeline import device_map as tdm

CPU = torch.device("cpu")


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(rng, B, L, lo, hi, alphabet=b"ACGT"):
    """(B, L) uint8 reads of random lengths in [lo, hi), zero padded."""
    letters = np.frombuffer(alphabet, np.uint8)
    arr = np.zeros((B, L), np.uint8)
    lens = rng.integers(lo, hi, B).astype(np.int32)
    for b in range(B):
        arr[b, :lens[b]] = letters[rng.integers(0, len(letters), lens[b])]
    return arr, lens


def test_encode_matches_jax():
    rng = np.random.default_rng(1)
    arr, lens = _batch(rng, 6, 64, 1, 64, alphabet=b"ACGTNacgt-")
    np.testing.assert_array_equal(
        tenc.seq_to_codes(_t(arr)).numpy(),
        _np(jenc.seq_to_codes(arr)).astype(np.int64))
    np.testing.assert_array_equal(
        tenc.reverse_complement_bytes(_t(arr), _t(lens)).numpy(),
        _np(jenc.reverse_complement_bytes(arr, lens)))
    for k in (5, 15, 17):          # 17: the hash wraps mod 2^32
        th, tv = tenc.kmer_hashes(_t(arr), _t(lens), k)
        jh, jv = jenc.kmer_hashes(arr, lens, k)
        np.testing.assert_array_equal(th.numpy(), _np(jh).astype(np.int64))
        np.testing.assert_array_equal(tv.numpy(), _np(jv))


@pytest.mark.parametrize("oob", [False, True])
@pytest.mark.parametrize("k,w", [(15, 5), (5, 3), (4, 1)])
def test_minimize_batch_matches_jax(k, w, oob):
    rng = np.random.default_rng(100 * k + w)
    # Lengths from below k up to the padded width, so every end-window
    # boundary (and the OOB prefix windows) is crossed.
    arr, lens = _batch(rng, 12, 96, 1, 97)
    got = tmz.minimize_batch(_t(arr), _t(lens), k, w, oob_end_windows=oob)
    want = jmz.minimize_batch(arr, lens, k, w, oob_end_windows=oob)
    np.testing.assert_array_equal(got.hashes.numpy(),
                                  _np(want.hashes).astype(np.int64))
    for f in ("pos", "valid", "dedup_keep"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)), err_msg=f)


def test_compact_queries_matches_jax():
    rng = np.random.default_rng(7)
    arr, lens = _batch(rng, 8, 200, 20, 200)
    m = jmz.minimize_batch(arr, lens, 15, 5)
    h, p, keep = (_np(m.hashes), _np(m.pos), _np(m.dedup_keep))
    for cap in (16, 64, 400):      # truncating, tight and loose caps
        got = tmatch.compact_queries(_t(h.astype(np.int64)), _t(p),
                                     _t(keep), cap)
        want = jmatch.compact_queries(h, p, keep, cap)
        np.testing.assert_array_equal(got[0].numpy(),
                                      _np(want[0]).astype(np.int64))
        for g, w_ in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), _np(w_))


def _index_arrays(didx):
    return {f: _np(getattr(didx, f)) for f in
            ("key_hash", "key_pos", "cnt_fr", "cnt_r2", "bucket_off",
             "ref_bytes", "ref_len")}


@pytest.mark.parametrize("direct", [False, True])
def test_find_matches_combined_matches_jax(direct, monkeypatch):
    k, w = (10, 3) if direct else (11, 5)
    monkeypatch.setenv("BIOINFO1_DIRECT_INDEX", "1" if direct else "0")
    rng = np.random.default_rng(31 + direct)
    genome = np.frombuffer(b"CATG", np.uint8)[rng.integers(0, 4, 20000)]
    gstr = genome.tobytes().decode("latin1")
    index = builder.build_index(gstr, k, w, 0.0)
    jidx = jdm.device_index_from_host(index)
    assert (jidx.bsearch_steps == 0) == direct
    tidx = tdm.device_index_from_numpy(
        _index_arrays(jidx), jidx.shift, jidx.bsearch_steps, jidx.cnt_shift,
        CPU)
    # Reads sampled from the genome (hits on both strands) plus junk.
    B, L = 10, 300
    arr = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ATGC", b"TACG"):
        comp[a] = b
    for b in range(B):
        ln = int(rng.integers(60, L + 1))
        s = int(rng.integers(0, len(genome) - ln))
        frag = genome[s:s + ln]
        if b % 3 == 1:
            frag = comp[frag[::-1]]
        if b == B - 1:
            frag = np.frombuffer(b"CATG", np.uint8)[rng.integers(0, 4, ln)]
        arr[b, :ln] = frag
        lens[b] = ln
    m = jmz.minimize_batch(arr, lens, k, w)
    qh, qp, qk, _ = jmatch.compact_queries(m.hashes, m.pos, m.dedup_keep,
                                           128)
    qh, qp, qk = _np(qh), _np(qp), _np(qk)
    for budget in (64, 512):       # overflowing and roomy budgets
        want = jmatch.find_matches_combined(
            qh, qp, qk, jidx.key_hash, jidx.key_pos, jidx.cnt_fr,
            jidx.cnt_r2, jidx.bucket_off, jidx.shift, jidx.bsearch_steps,
            budget, jidx.cnt_shift)
        got = tmatch.find_matches_combined(
            _t(qh.astype(np.int64)), _t(qp), _t(qk), tidx.key_hash,
            tidx.key_pos, tidx.cnt_fr, tidx.cnt_r2, tidx.bucket_off,
            tidx.shift, tidx.bsearch_steps, budget, tidx.cnt_shift)
        for g, w_ in zip(got, want):
            assert int(_np(w_.count).sum()) > 0
            for f in ("f_pos", "r_pos", "count", "total", "overflow"):
                np.testing.assert_array_equal(
                    getattr(g, f).numpy(), _np(getattr(w_, f)),
                    err_msg=f"{f} budget={budget}")
