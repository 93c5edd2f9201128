"""CUDA kernels of the port against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips (in a fixture, at run time) when torch
sees no CUDA device.  On a machine with one, run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the repository's conftest configures JAX, which the
port and this file do not need).  Comparisons are exact: integer outputs,
tolerance 0.  Banded parents are compared on the cells they are defined on
(ops/band.parent_cells); walk codes and CIGARs on every read the strict
certificate passes, or on all reads where both walks get the same parents.
"""

import io

import numpy as np
import pytest
import torch

from bioinfo1_tpu_torch.index import builder
from bioinfo1_tpu_torch.ops import align as al
from bioinfo1_tpu_torch.ops import band as bd
from bioinfo1_tpu_torch.ops import chain as ch
from bioinfo1_tpu_torch.ops import probe
from bioinfo1_tpu_torch.ops import trace as tr
from bioinfo1_tpu_torch.pipeline import device_map as dm
from bioinfo1_tpu_torch.utils import simulate

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same(got, want):
    for f in got.__dataclass_fields__:
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
            continue
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      getattr(want, f).cpu().numpy(),
                                      err_msg=f)


def _chain_rows(rng, R, N):
    f = np.zeros((R, N), np.int32)
    r = np.zeros((R, N), np.int32)
    cnt = rng.integers(0, N + 1, R).astype(np.int32)
    cnt[0], cnt[1] = 0, N
    for b in range(R):
        n = int(cnt[b])
        fs = np.sort(rng.integers(1, max(4 * N, 20000), n)).astype(np.int32)
        rs = fs + rng.integers(0, 3, n).astype(np.int32) * (4999 + b % 2)
        f[b, :n], r[b, :n] = fs, np.maximum(rs, 1)
    return f, r, cnt


@pytest.mark.parametrize("R,N", [(8, 128), (32, 1536), (8, 4096),
                                 (4, 20480)])
def test_lis_chain_kernel_matches_plain(dev, R, N):
    f, r, cnt = (torch.from_numpy(x).to(dev)
                 for x in _chain_rows(np.random.default_rng(N), R, N))
    _same(ch.lis_chain(f, r, cnt), ch.lis_chain_plain(f, r, cnt))


def _pairs(rng, B, n, m, dev):
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(n // 4, n + 1))
        tgt = simulate.random_genome(min(m, int(ln * 1.3) + 8), rng)
        qry = simulate.mutate_read(tgt[:ln], rng)[:n]
        if b % 5 == 0:
            tgt = simulate.random_genome(m, rng)
        qa[b, :len(qry)], ql[b] = qry, len(qry)
        ta[b, :len(tgt)], tl[b] = tgt, len(tgt)
        if b % 4 == 1:
            qa[b, 3], ta[b, 7] = ord("-"), ord("-")
    ql[-1] = tl[-1] = 0
    return [torch.from_numpy(x).to(dev) for x in (qa, ql, ta, tl)]


@pytest.mark.parametrize("band", [128, 256, 4096, 19968])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_kernel_matches_plain(dev, mode, band):
    q, ql, t, tl = _pairs(np.random.default_rng(mode), 12, 600, 900, dev)
    for dash_free in (False, True):
        args = (q, ql, t, tl, 1, -1, -1)
        _same(bd.align_scores_banded(*args, band=band, mode=mode,
                                     dash_free=dash_free),
              bd.align_scores_banded_plain(*args, band=band, mode=mode,
                                           dash_free=dash_free))


@pytest.mark.parametrize("band", [128, 256, 4096, 19968])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_parents_kernel_matches_plain(dev, mode, band):
    q, ql, t, tl = _pairs(np.random.default_rng(10 + mode), 12, 600, 900,
                          dev)
    m_eff = bd.band_shapes(600, 900, band)[2]
    for dash_free in (False, True):
        args = (q, ql, t, tl, 1, -1, -1)
        got = bd.align_scores_banded(*args, band=band, mode=mode,
                                     dash_free=dash_free, want_parents=True)
        want = bd.align_scores_banded_plain(*args, band=band, mode=mode,
                                            dash_free=dash_free,
                                            want_parents=True)
        for f in ("score", "goal_i", "goal_j"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(bd.parent_cells(got.parents, ql, tl, m_eff),
                           bd.parent_cells(want.parents, ql, tl, m_eff))
        # The walk kernel against the plain walk on the same parents.
        walk_args = (got.parents, got.goal_i, got.goal_j, got.score, q, t,
                     1, -1, -1, mode)
        assert torch.equal(tr.walk_parents(*walk_args),
                           tr.walk_parents_plain(*walk_args))


@pytest.mark.parametrize("scoring", [(1, -1, 1), (1, -1, 0)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_band_parents_whole_matrix_matches_plain(dev, mode, scoring):
    """The staged path's -c shape: a band that covers the whole matrix,
    under scorings with no exactness certificate (many ties)."""
    q, ql, t, tl = _pairs(np.random.default_rng(20 + mode), 12, 600, 900,
                          dev)
    W = -(-max(int(ql.max()), int(tl.max()) + 2) // 128) * 128
    m_eff = bd.band_shapes(600, 900, W)[2]
    args = (q, ql, t, tl, *scoring)
    got = bd.align_scores_banded(*args, band=W, mode=mode,
                                 want_parents=True)
    want = bd.align_scores_banded_plain(*args, band=W, mode=mode,
                                        want_parents=True)
    for f in ("score", "goal_i", "goal_j"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(bd.parent_cells(got.parents, ql, tl, m_eff),
                       bd.parent_cells(want.parents, ql, tl, m_eff))
    assert bool(bd.certify(got.score, *args, W, strict=True,
                           mode=mode).all())
    walk_args = (got.parents, got.goal_i, got.goal_j, got.score, q, t,
                 *scoring, mode)
    assert torch.equal(tr.walk_parents(*walk_args),
                       tr.walk_parents_plain(*walk_args))
    # The full-matrix score kernel sees the same DP.
    full = al.align_scores(q, ql, t, tl, mode, *scoring)
    for f in ("score", "goal_i", "goal_j"):
        assert torch.equal(getattr(got, f), getattr(full, f)), f


@pytest.mark.parametrize("shape,n_iter", [((256, 1024), 100), ((8, 128), 0),
                                          ((3, 5, 7), 7), ((1000,), 33)])
def test_int32_probe_kernel_matches_plain(dev, shape, n_iter):
    rng = np.random.default_rng(n_iter)
    x = torch.from_numpy(rng.integers(-10**6, 10**6, shape)
                         .astype(np.int32)).to(dev)
    x.view(-1)[:3] = torch.tensor([2**31 - 1, -2**31, 2**31 - 50],
                                  dtype=torch.int32)     # wrap-around
    before = probe.int32_probe.launches
    got = probe.int32_probe(x, n_iter)
    assert probe.int32_probe.launches == before + 1
    assert torch.equal(got, probe.int32_probe_plain(x, n_iter))
    with pytest.raises(ValueError):
        probe.int32_probe(x.view(-1)[::2], 1)           # not contiguous


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("scoring", [(1, -1, -1), (2, -3, 1)])
def test_full_kernel_matches_plain(dev, mode, scoring):
    q, ql, t, tl = _pairs(np.random.default_rng(7), 16, 300, 500, dev)
    _same(al.align_scores(q, ql, t, tl, mode, *scoring),
          al.align_scores_plain(q, ql, t, tl, mode, *scoring))


def test_wrappers_reject_bad_input(dev):
    f = torch.zeros((2, 8), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        ch.lis_chain(f, f, torch.zeros(2, dtype=torch.int32, device=dev))
    q = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    n = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        bd.align_scores_banded(q, n, q, n, 1, -1, -1)
    par = torch.zeros((4, 2, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        tr.walk_parents(par, n, n, n, q, q, 1, -1, -1, 0)


def _map_problem():
    rng = np.random.default_rng(11)
    genome = simulate.random_genome(60000, rng)
    index = builder.build_index(genome.tobytes().decode("latin1"), 13, 5,
                                0.001)
    recs = simulate.simulate_reads(genome, rng.integers(300, 2000, 24), rng)
    L = 2048
    arr = np.zeros((len(recs), L), np.uint8)
    lens = np.zeros(len(recs), np.int32)
    for i, (_, s) in enumerate(recs):
        arr[i, :len(s)] = np.frombuffer(s.encode("latin1"), np.uint8)
        lens[i] = len(s)
    return index, arr, lens


@pytest.mark.parametrize("band", [0, 256])
def test_map_step_cuda_matches_cpu(dev, band):
    index, arr, lens = _map_problem()
    outs = []
    for d in (dev, torch.device("cpu")):
        didx = dm.device_index_from_host(index, d)
        outs.append(dm.map_step(
            torch.from_numpy(arr).to(d), torch.from_numpy(lens).to(d), didx,
            1, -1, -1, k=13, w=5, mode=0, budget=1024, region_cap=4096,
            band=band).to_numpy())
    assert outs[0].mapped.sum() > 12
    for f in outs[0].__dataclass_fields__:
        np.testing.assert_array_equal(getattr(outs[0], f),
                                      getattr(outs[1], f), err_msg=f)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_map_step_cigar_cuda_matches_cpu(dev, mode):
    index, arr, lens = _map_problem()
    outs = []
    for d in (dev, torch.device("cpu")):
        didx = dm.device_index_from_host(index, d)
        outs.append(dm.map_step_cigar(
            torch.from_numpy(arr).to(d), torch.from_numpy(lens).to(d), didx,
            1, -1, -1, k=13, w=5, mode=mode, budget=1024, region_cap=4096,
            band=256).to_numpy())
    got, want = outs
    assert got.base.mapped.sum() > 12
    for f in got.base.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got.base, f),
                                      getattr(want.base, f), err_msg=f)
    for f in ("goal_i", "goal_j", "q_len", "t_len", "certified"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    ok = got.base.mapped & got.certified
    assert ok.sum() > 8
    np.testing.assert_array_equal(got.codes[:, ok], want.codes[:, ok])


@pytest.mark.parametrize("flags", [[], ["-c"], ["-c", "-a", "local"],
                                   ["-c", "-a", "semiGlobal"],
                                   ["-c", "-g", "1"],
                                   ["-c", "-a", "semiGlobal", "-g", "1"]])
def test_cli_cuda_matches_cpu(dev, tmp_path, monkeypatch, flags):
    from bioinfo1_tpu_torch import cli
    rng = np.random.default_rng(3)
    genome = simulate.random_genome(50000, rng)
    (tmp_path / "ref.fa").write_text(
        ">g\n" + genome.tobytes().decode("latin1") + "\n")
    recs = simulate.simulate_reads(genome, [300, 900, 2500, 4000] * 4, rng)
    with open(tmp_path / "r.fq", "w") as fh:
        for name, s in recs:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")
    outs = []
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("BIOINFO1_PLATFORM", platform)
        out = io.StringIO()
        assert cli.main(flags + [str(tmp_path / "ref.fa"),
                                 str(tmp_path / "r.fq")], stdout=out) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") >= 12
    assert outs[0].count("cg:Z:") == (outs[0].count("\n") if flags else 0)


def test_cli_bug_compat_fasta_cuda_matches_cpu(dev, tmp_path, monkeypatch):
    """FASTA match nesting: the whole run on the staged host path."""
    from bioinfo1_tpu_torch import cli
    rng = np.random.default_rng(4)
    genome = simulate.random_genome(50000, rng)
    (tmp_path / "ref.fa").write_text(
        ">g\n" + genome.tobytes().decode("latin1") + "\n")
    recs = simulate.simulate_reads(genome, [300, 900, 2500] * 6, rng)
    with open(tmp_path / "r.fa", "w") as fh:
        for name, s in recs:
            fh.write(f">{name}\n{s}\n")
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")
    for flags in (["--bug-compat"], ["--bug-compat", "-c", "-a", "local"]):
        outs = []
        for platform in ("cuda", "cpu"):
            monkeypatch.setenv("BIOINFO1_PLATFORM", platform)
            out = io.StringIO()
            assert cli.main(flags + [str(tmp_path / "ref.fa"),
                                     str(tmp_path / "r.fa")],
                            stdout=out) == 0
            outs.append(out.getvalue())
        assert outs[0] == outs[1]
        assert outs[0].count("\n") >= 5
