"""CUDA kernels of the port against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips (in a fixture, at run time) when torch
sees no CUDA device.  On a machine with one, run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the repository's conftest configures JAX, which the
port and this file do not need).  Comparisons are exact: integer outputs,
tolerance 0.
"""

import io

import numpy as np
import pytest
import torch

from bioinfo1_tpu.index import builder
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch.ops import align as al
from bioinfo1_tpu_torch.ops import band as bd
from bioinfo1_tpu_torch.ops import chain as ch
from bioinfo1_tpu_torch.pipeline import device_map as dm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same(got, want):
    for f in got.__dataclass_fields__:
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


@pytest.mark.parametrize("band", [0, 256])
def test_map_step_cuda_matches_cpu(dev, band):
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


def test_cli_cuda_matches_cpu(dev, tmp_path, monkeypatch):
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
        assert cli.main([str(tmp_path / "ref.fa"), str(tmp_path / "r.fq")],
                        stdout=out) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") >= 12
