"""Per-batch fault isolation in ``Mapper.map_batch``, port against the JAX
package.

The same reads go through both packages' ``Mapper.map_records`` on the CPU
while each mapper's fused step (``_map_bucket_fused``) is patched to fail:
once, always, with a device out-of-memory error twice and then no more, and
with one always.  Under the same failure both must print the same PAF lines,
count the same ``faults`` and print the same ``ERROR: Exception during
Align:`` lines on stderr: an error sends the batch to the host path, an
out-of-memory error reruns it on the device at the same budget (at most six
attempts), and a failure on the host path reports its reads unmapped.  The
JAX package names an out-of-memory error by ``RESOURCE_EXHAUSTED`` in its
message, the port by ``torch.cuda.OutOfMemoryError``; both messages are the
same here.  A CUDA error that the host path meets again ends the port's
run.
"""

import threading

import numpy as np
import pytest
import torch

from bioinfo1_tpu.pipeline import mapper as jmapper
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch.pipeline import mapper as tmapper

CPU = torch.device("cpu")
K, W = 11, 5
OOM_MSG = "RESOURCE_EXHAUSTED: out of memory allocating 1073741824 bytes"


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(606)
    genome = simulate.random_genome(30000, rng)
    gstr = genome.tobytes().decode("latin1")
    # No read whose chain outgrows the step's cap: after an out-of-memory
    # rerun such a read stays on the device and doubles its match budget
    # up to the 24-attempt limit, in both packages (ROADMAP C6).
    recs = simulate.simulate_reads(genome, [600, 700, 800, 1400, 1500], rng)
    cfg = dict(k=K, w=W, f=0.0)
    clean = jmapper.Mapper([("chr", gstr)],
                           jmapper.MapperConfig(**cfg)).map_records(recs)
    assert len(clean) >= 4
    return gstr, recs, cfg, clean


def _failing(kind, oom_error):
    """A stand-in for ``_map_bucket_fused`` that raises as ``kind`` says
    and otherwise calls the real one."""
    calls = [0]
    lock = threading.Lock()

    def patch(real):
        def fused(*args, **kwargs):
            with lock:
                calls[0] += 1
                n = calls[0]
            if kind == "once" and n == 1 or kind == "always":
                raise RuntimeError("injected device fault")
            if kind == "oom_twice" and n <= 2 or kind == "oom_always":
                raise oom_error(OOM_MSG)
            return real(*args, **kwargs)
        return fused
    return patch


def _run(pkg, gstr, recs, cfg, kind, capsys):
    if pkg is jmapper:
        m = pkg.Mapper([("chr", gstr)], pkg.MapperConfig(**cfg))
        oom = RuntimeError
    else:
        m = pkg.Mapper([("chr", gstr)], pkg.MapperConfig(**cfg), device=CPU)
        oom = torch.cuda.OutOfMemoryError
    m._map_bucket_fused = _failing(kind, oom)(m._map_bucket_fused)
    capsys.readouterr()
    lines = m.map_records(recs)
    err = [line for line in capsys.readouterr().err.splitlines()
           if line.startswith("ERROR: Exception during Align:")]
    return lines, m.counters.faults, sorted(err)


@pytest.mark.parametrize("kind", ["once", "always", "oom_twice",
                                  "oom_always"])
def test_fused_faults_match_jax(problem, capsys, kind):
    gstr, recs, cfg, clean = problem
    want = _run(jmapper, gstr, recs, cfg, kind, capsys)
    got = _run(tmapper, gstr, recs, cfg, kind, capsys)
    assert got == want
    lines, faults, err = got
    # Every route recovers the batch: the host path, or the device again.
    assert lines == clean
    assert faults == len(err) >= {"once": 1, "always": 1, "oom_twice": 2,
                                  "oom_always": 6}[kind]
    if kind == "oom_always":
        assert faults % 6 == 0           # six device attempts per batch


def test_host_path_faults_report_reads_unmapped(problem, capsys,
                                                monkeypatch):
    """The fused step and the host path both fail: the run goes on, every
    read unmapped, as in the JAX package."""
    gstr, recs, cfg, _ = problem

    def boom(*args, **kwargs):
        raise RuntimeError("injected host fault")

    monkeypatch.setattr(jmapper, "_map_bucket", boom)
    want = _run(jmapper, gstr, recs, cfg, "always", capsys)
    monkeypatch.setattr(tmapper.Mapper, "_map_bucket", boom)
    got = _run(tmapper, gstr, recs, cfg, "always", capsys)
    assert got == want
    assert got[0] == [] and got[1] >= 2


def test_cuda_error_on_the_host_path_ends_the_run(problem, capsys,
                                                  monkeypatch):
    """A CUDA error goes to the host path once; met there again it ends the
    run (a sticky error poisons the context) instead of reporting every
    later batch unmapped."""
    gstr, recs, cfg, _ = problem
    msg = "bioinfo1_band_score: CUDA error 700 (an illegal memory access)"

    def boom(*args, **kwargs):
        raise RuntimeError(msg)

    m = tmapper.Mapper([("chr", gstr)], tmapper.MapperConfig(**cfg),
                       device=CPU)
    m._map_bucket_fused = boom
    monkeypatch.setattr(tmapper.Mapper, "_map_bucket", boom)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        m.map_records(recs)
    assert m.counters.faults >= 2
    assert f"ERROR: Exception during Align: {msg}" in capsys.readouterr().err


def test_profile_counters_carry_faults():
    assert "faults" in tmapper.MapperCounters().as_dict()
