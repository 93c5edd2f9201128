"""The port's own host modules against the JAX package's originals.

``bioinfo1_tpu_torch`` keeps its own copy of every host-only module it
needs (index builder, FASTA/FASTQ parsing, CIGAR and statistics text, the
read simulator, the ctypes binding of the native library).  Each copy is
held exactly equal to its original on seeded inputs.
"""

import dataclasses
import gzip

import numpy as np
import pytest

from bioinfo1_tpu import native as jnative
from bioinfo1_tpu.index import builder as jbuilder
from bioinfo1_tpu.io import fastx as jfastx
from bioinfo1_tpu.utils import cigar as jcigar
from bioinfo1_tpu.utils import simulate as jsim
from bioinfo1_tpu.utils import stats as jstats
from bioinfo1_tpu_torch import native as tnative
from bioinfo1_tpu_torch.index import builder as tbuilder
from bioinfo1_tpu_torch.io import fastx as tfastx
from bioinfo1_tpu_torch.utils import cigar as tcigar
from bioinfo1_tpu_torch.utils import simulate as tsim
from bioinfo1_tpu_torch.utils import stats as tstats

BUG_COMPAT = dict(banned_rev_from_fwd=True, threshold_from_rev_unique=True,
                  exact_ties=True, oob_end_windows=True)


def _genome(n=30000, seed=11) -> str:
    g = jsim.repeat_genome(n, np.random.default_rng(seed), is_elements=9,
                           is_len=300, rrn_operons=3, rrn_len=600,
                           tandem_loci=5, tandem_unit=40, tandem_copies=6)
    return g.tobytes().decode("latin1")


def _assert_index_equal(a, b):
    for f in ("ref_len", "k", "w", "ref_fwd_seq", "ref_rev_seq"):
        assert getattr(a, f) == getattr(b, f), f
    for strand in ("fwd", "rev"):
        sa, sb = getattr(a, strand), getattr(b, strand)
        for f in dataclasses.fields(sa):
            va, vb = getattr(sa, f.name), getattr(sb, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype, (strand, f.name)
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, (strand, f.name)


@pytest.mark.parametrize("k,w,f,flags", [
    (15, 5, 0.001, {}),
    (7, 3, 0.02, {}),
    (15, 5, 0.001, BUG_COMPAT),
    (7, 3, 0.02, BUG_COMPAT),
])
def test_build_index_equal(k, w, f, flags):
    ref = _genome()
    _assert_index_equal(tbuilder.build_index(ref, k, w, f, **flags),
                        jbuilder.build_index(ref, k, w, f, **flags))
    assert tbuilder.reverse_complement_str(ref[:999] + "N-x") == \
        jbuilder.reverse_complement_str(ref[:999] + "N-x")


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_index_round_trip_either_package(tmp_path, writer, reader):
    mods = {"torch": tbuilder, "jax": jbuilder}
    ref = _genome(12000, seed=3)
    idx = mods[writer].build_index(ref, 9, 4, 0.01)
    path = str(tmp_path / "idx.npz")
    mods[writer].save_index(idx, path)
    got = mods[reader].load_index(path)
    got.ref_fwd_seq, got.ref_rev_seq = idx.ref_fwd_seq, idx.ref_rev_seq
    _assert_index_equal(got, idx)


def _records(seed=5, n=17):
    rng = np.random.default_rng(seed)
    g = jsim.random_genome(20000, rng)
    return jsim.simulate_reads(g, rng.integers(30, 900, n).tolist(), rng)


def _write_fastx(tmp_path, recs):
    fa, fq = tmp_path / "r.fa", tmp_path / "r.fq"
    with open(fa, "w") as fh:
        for i, (name, s) in enumerate(recs):
            # multi-line FASTA bodies, a header with a comment
            fh.write(f">{name} comment {i}\n")
            for o in range(0, len(s), 70):
                fh.write(s[o:o + 70] + "\n")
    with open(fq, "w") as fh:
        for name, s in recs:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    gz = tmp_path / "r.fq.gz"
    with gzip.open(gz, "wt") as fh:
        fh.write(fq.read_text())
    bad = tmp_path / "bad.txt"
    bad.write_text("neither\nformat\n")
    return str(fa), str(fq), str(gz), str(bad)


def test_fastx_parsing_equal(tmp_path):
    recs = _records()
    fa, fq, gz, bad = _write_fastx(tmp_path, recs)
    assert tfastx.parse_fasta_any(fa) == jfastx.parse_fasta_any(fa)
    assert tfastx.parse_fasta(fa) == jfastx.parse_fasta(fa)
    assert tfastx.parse_fastq(fq) == jfastx.parse_fastq(fq)
    for path in (fa, fq, gz):
        got, want = tfastx.parse_reads(path), jfastx.parse_reads(path)
        assert (got.records, got.is_fastq) == (want.records, want.is_fastq)
        assert [name for name, _ in got.records] == [n for n, _ in recs]
        ts, js = tfastx.stream_reads(path, 2000), jfastx.stream_reads(path,
                                                                      2000)
        assert ts.is_fastq == js.is_fastq
        assert list(ts.batches) == list(js.batches)
    for kind, path in (("fasta", fa), ("fastq", fq)):
        r = tfastx.parse_reads(path).records
        assert tfastx.basic_statistics(r, kind) == \
            jfastx.basic_statistics(r, kind)
    with pytest.raises(tfastx.FormatError):
        tfastx.parse_reads(bad)
    with pytest.raises(tfastx.FormatError):
        tfastx.parse_fasta_any(fq)


@pytest.mark.parametrize("lo,hi", [(0, 5), (4, 11), (15, 40), (17, 17)])
def test_fastx_sliced_parse_equal(tmp_path, lo, hi):
    fa, fq, _gz, _bad = _write_fastx(tmp_path, _records())
    for path in (fa, fq):
        got, n_got = tfastx.parse_reads_slice(path, lo, hi)
        want, n_want = jfastx.parse_reads_slice(path, lo, hi)
        assert n_got == n_want == 17
        assert (got.records, got.is_fastq) == (want.records, want.is_fastq)


def _codes(rng, steps, pad):
    c = rng.choice(np.array([0, 0, 0, 1, 2], np.uint8), steps)
    c[rng.random(steps) < 0.1] = 255          # skipped mid-stream
    return np.concatenate([c, np.full(pad, 255, np.uint8)])


@pytest.mark.parametrize("mode", ["global", "local", "semiGlobal"])
def test_cigar_from_codes_equal(mode):
    rng = np.random.default_rng(21)
    for _ in range(20):
        codes = _codes(rng, int(rng.integers(0, 60)), 5)
        ops = codes[codes != 255]
        n = int(np.count_nonzero(ops != 1)) + int(rng.integers(0, 4))
        m = int(np.count_nonzero(ops != 2)) + int(rng.integers(0, 4))
        gi, gj = (n, m - 2) if rng.random() < 0.5 else (max(n - 2, 0), m)
        for sam in (False, True):
            for tbe in (False, True):
                kw = dict(sam_convention=sam, local_target_begin_end=tbe)
                assert tcigar.cigar_from_codes(codes, mode, gi, gj, n, m,
                                               **kw) == \
                    jcigar.cigar_from_codes(codes, mode, gi, gj, n, m, **kw)
    assert tcigar.compress("MMIDDM") == jcigar.compress("MMIDDM")
    assert tcigar.compress("MMIDDM", True) == jcigar.compress("MMIDDM", True)


def test_statistics_text_equal():
    rng = np.random.default_rng(8)
    hashes = rng.integers(0, 50, (4, 64)).astype(np.uint32)
    valid = rng.random((4, 64)) < 0.8
    valid[3] = False
    for b in range(4):
        assert tstats.read_statistics(hashes[b], valid[b]) == \
            jstats.read_statistics(hashes[b], valid[b])
    idx = jbuilder.build_index(_genome(8000, seed=2), 9, 4, 0.01)
    args = ((idx.fwd.n_distinct_hashes, idx.fwd.n_singleton_hashes,
             idx.fwd.top_surviving),
            (idx.rev.n_distinct_hashes, idx.rev.n_singleton_hashes, None), 9)
    assert tstats.index_statistics(*args) == jstats.index_statistics(*args)
    for x in (0.0, 1 / 3, 12345.678, 1e-7):
        assert tstats.fmt_double(x) == jstats.fmt_double(x)
    assert tstats.decode_hash(0x2D3F1, 9) == jstats.decode_hash(0x2D3F1, 9)


@pytest.mark.parametrize("seed", [0, 20250817 + 5])
def test_simulator_draws_equal(seed):
    got = tsim.repeat_genome(60000, np.random.default_rng(seed))
    want = jsim.repeat_genome(60000, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    lengths = [200, 2000, 4000, 350]
    for kw in ({}, dict(sub_rate=0.015, ins_rate=0.007, del_rate=0.008)):
        assert tsim.simulate_reads(got, lengths, np.random.default_rng(seed),
                                   **kw) == \
            jsim.simulate_reads(want, lengths, np.random.default_rng(seed),
                                **kw)


def _packed_codes(rng, B, steps):
    """(S4, B) packed walk codes (4 per byte, 3 = done) and their unpacked
    (4 * S4, B) form with done = 255."""
    codes = np.full((steps, B), 255, np.uint8)
    for b in range(B):
        n = int(rng.integers(0, steps))
        codes[:n, b] = rng.choice(np.array([0, 0, 1, 2], np.uint8), n)
    c = np.where(codes == 255, 3, codes).reshape(steps // 4, 4, B)
    packed = (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4)
              | (c[:, 3] << 6)).astype(np.uint8)
    return packed, codes


@pytest.mark.parametrize("mode", ["global", "local", "semiGlobal"])
def test_cigar_rle_batch_native_against_fallback(mode):
    """The port's binding of native/cigar.cpp against its Python spec
    (utils.cigar.cigar_from_codes), and against the JAX package's
    binding."""
    rng = np.random.default_rng(4)
    packed, codes = _packed_codes(rng, 9, 48)
    cols = np.array([0, 3, 4, 8], np.int32)
    ops = [codes[:, c][codes[:, c] != 255] for c in cols]
    ql = np.array([np.count_nonzero(o != 1) for o in ops], np.int32)
    tl = np.array([np.count_nonzero(o != 2) for o in ops], np.int32)
    gi, gj = ql.copy(), tl.copy()
    for sam in (False, True):
        kw = dict(sam_convention=sam, local_target_begin_end=sam)
        got = tnative.cigar_rle_batch(packed, cols, gi, gj, ql, tl, mode,
                                      **kw)
        assert got == jnative.cigar_rle_batch(packed, cols, gi, gj, ql, tl,
                                              mode, **kw)
        if got is None:             # no toolchain: the fallback serves
            continue
        want = [tcigar.cigar_from_codes(codes[:, c], mode, int(gi[k]),
                                        int(gj[k]), int(ql[k]), int(tl[k]),
                                        **kw) for k, c in enumerate(cols)]
        assert got[0] == [w[0] for w in want]
        assert got[1] == [w[1] for w in want]


@pytest.mark.parametrize("with_cigar", [False, True])
def test_paf_format_native_against_fallback(with_cigar):
    from bioinfo1_tpu_torch.pipeline.mapper import ReadMapping, paf_line
    ms = [ReadMapping(True, True, 3, 90, 1000, 1100, 57, "88M", 0),
          ReadMapping(False),
          ReadMapping(True, False, 0, 49, 5, 60, -3, "20M3I27M", 7)]
    names, lens = ["a", "b b", "c"], [100, 40, 50]
    got = tnative.paf_format(names, lens, ms, "chr 1", 5000, with_cigar)
    assert got == jnative.paf_format(names, lens, ms, "chr 1", 5000,
                                     with_cigar)
    if got is not None:
        assert got == [paf_line(n, ln, m, "chr 1", 5000, with_cigar)
                       for n, ln, m in zip(names, lens, ms) if m.mapped]
