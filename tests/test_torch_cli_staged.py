"""Port CLI against the JAX CLI on the staged host path: byte-identical PAF.

The configurations that no fused step can finish run on the mapper's
staged path (``Mapper._map_bucket``): ``-c`` where no exactness
certificate exists (global with gap >= 0, local / semiGlobal with
gap > 0), here, and ``--bug-compat`` on a FASTA reads file (FASTA match
nesting), with and without ``-c``, in all three ``-a`` modes
(test_torch_cli_staged_fasta.py, a file of its own so the two halves run
on different test workers).  A ~40 kb genome and 10 reads of 200-1300 bp
go through ``bioinfo1_tpu_torch.cli.main`` on the CPU and
``bioinfo1_tpu.cli.main``; stdout must be identical.
"""

import io
import json

import numpy as np
import pytest

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch import cli as tcli
from test_torch_cli import _one_native_library  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_staged")
    rng = np.random.default_rng(20251016)
    genome = simulate.random_genome(40000, rng)
    gstr = genome.tobytes().decode("latin1")
    lengths = [220, 300, 450, 700, 1200, 1300]
    recs = simulate.simulate_reads(genome, lengths, rng)
    recs += simulate.simulate_reads(genome, [350, 900], rng, sub_rate=0.01,
                                    ins_rate=0.0, del_rate=0.0)
    s0 = 12000
    recs.append(("del300", gstr[s0:s0 + 600] + gstr[s0 + 900:s0 + 1500]))
    # Literal '-' bytes: gaps against them cost 0.
    recs.append(("dash", gstr[5000:5400] + "-" * 3 + gstr[5400:5700]))
    ref = d / "ref.fa"
    ref.write_text(f">chr\n{gstr}\n")
    fq = d / "reads.fq"
    fa = d / "reads.fa"
    with open(fq, "w") as fh:
        for name, s in recs:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    with open(fa, "w") as fh:
        for name, s in recs:
            fh.write(f">{name}\n{s}\n")
    return str(ref), str(fq), str(fa), len(recs)


def _run(main, args):
    out, err = io.StringIO(), io.StringIO()
    rc = main(args, stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")


def _parity(inputs, flags, reads):
    ref, fq, fa, n = inputs
    args = flags + [ref, fq if reads == "fq" else fa]
    rc_t, out_t, err_t = _run(tcli.main, args + ["--profile"])
    rc_j, out_j, _ = _run(jcli.main, args)
    assert (rc_t, rc_j) == (0, 0), err_t
    assert out_t == out_j
    assert out_t.count("\n") >= n // 2
    if "-c" in flags:
        assert out_t.count("\tcg:Z:") == out_t.count("\n")
    return json.loads(err_t.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["-c", "-g", "1"],
    ["-c", "-g", "0"],
    ["-c", "-a", "local", "-g", "1"],
    ["-c", "-a", "semiGlobal", "-g", "1"],
], ids=lambda f: "_".join(x.strip("-") for x in f))
def test_cigar_without_certificate_matches_jax(inputs, flags):
    """Every read ends on the host route: the fused -c step cannot certify
    (except a region its band already covers whole)."""
    counters = _parity(inputs, flags, "fq")
    assert counters["t_host_s"] > 0
    assert counters["host_fallbacks"] > 0
