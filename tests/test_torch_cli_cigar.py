"""Port CLI against the JAX CLI with -c: byte-identical PAF, cg:Z: included.

A ~40 kb simulated genome, 16 ONT-profile reads of 220-1500 bp and a
1.4 kb read with a 300-base deletion (it misses the band-256 certificate,
so the parents realign pass runs) go through ``bioinfo1_tpu_torch.cli.main``
on the CPU and ``bioinfo1_tpu.cli.main``.  Global mode, --sam-cigar and -o
here; test_torch_cli_cigar_modes.py covers local, semiGlobal and
--bug-compat (kept in a file of its own so the two halves run on
different test workers).
"""

import json

import numpy as np
import pytest

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch import cli as tcli
from test_torch_cli import (_cpu, _one_native_library,  # noqa: F401
                            _run)

N_READS = 17


@pytest.fixture(scope="module")
def cigar_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_cigar")
    rng = np.random.default_rng(20251016)
    genome = simulate.random_genome(40000, rng)
    gstr = genome.tobytes().decode("latin1")
    lengths = [220, 300, 450, 500, 800, 1000, 1200, 1400, 1500] * 2
    recs = simulate.simulate_reads(genome, lengths[:16], rng)
    s0 = 12000
    recs.append(("del300", gstr[s0:s0 + 700] + gstr[s0 + 1000:s0 + 1700]))
    ref = d / "ref.fa"
    ref.write_text(f">chr\n{gstr}\n")
    fq = d / "reads.fq"
    with open(fq, "w") as fh:
        for name, s in recs:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    return d, str(ref), str(fq)


def check_cigar_run(inputs, flags, realign: bool):
    """Both CLIs on ``flags``: equal rc 0 and stdout, a cg:Z: on every
    mapped read, and with ``realign`` the parents realign pass used."""
    _, ref, fq = inputs
    args = flags + [ref, fq]
    rc_t, out_t, err_t = _run(tcli.main, args + ["--profile"])
    rc_j, out_j, _ = _run(jcli.main, args)
    assert (rc_t, rc_j) == (0, 0), err_t
    assert out_t == out_j
    lines = out_t.splitlines()
    assert len(lines) >= N_READS - 1
    assert all(line.split("\t")[12].startswith("cg:Z:") and
               len(line.split("\t")[12]) > 6 for line in lines)
    counters = json.loads(err_t.strip().splitlines()[-1])
    if realign:
        assert counters["realign_batches"] > 0, counters
    return counters


@pytest.mark.parametrize("flags", [["-c"], ["-c", "--sam-cigar"]])
def test_cli_cigar_matches_jax(cigar_inputs, flags):
    check_cigar_run(cigar_inputs, flags, realign=True)


def test_cli_cigar_file_output_matches_jax(cigar_inputs):
    d, ref, fq = cigar_inputs
    want, got = d / "jax.paf", d / "torch.paf"
    args = ["-c", "-a", "semiGlobal", ref, fq]
    assert _run(jcli.main, ["-o", str(want)] + args)[0] == 0
    assert _run(tcli.main, ["-o", str(got)] + args)[0] == 0
    assert got.read_text() == want.read_text()
    assert got.read_text().count("cg:Z:") >= N_READS - 1
