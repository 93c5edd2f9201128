"""Port CLI against the JAX CLI: byte-identical output.

A ~40 kb simulated genome and ~24 ONT-profile reads of 200-3000 bp (one
with a 300-base deletion, so the realign pass runs) go through
``bioinfo1_tpu_torch.cli.main`` on the CPU and ``bioinfo1_tpu.cli.main``;
stdout, or the -o file, must be identical.  Covers FASTA and FASTQ reads,
global mode, -s, and -o with --resume (test_torch_cli_modes.py covers the
local and semiGlobal modes and --bug-compat, test_torch_cli_cigar*.py the
-c runs, test_torch_cli_staged*.py the staged host path).  Two runs the
port once refused with rc 1 now print the default run's output:
``--devices 2`` (the data-parallel step) and a coordinator address with
JAX_NUM_PROCESSES=1 (a one-process run under the multi-process variables;
test_torch_multiprocess.py runs several processes).
"""

import io
import json

import numpy as np
import pytest

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu import native as jnative
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch import cli as tcli
from bioinfo1_tpu_torch import native as tnative


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(20251016)
    genome = simulate.random_genome(40000, rng)
    gstr = genome.tobytes().decode("latin1")
    # Lengths in a few buckets: band-0 (<= 512), 1536 and 3072.
    lengths = [220, 300, 450, 500, 1200, 1400, 1500, 2600, 2800, 3000] * 2
    recs = simulate.simulate_reads(genome, lengths, rng)
    recs += simulate.simulate_reads(genome, [350, 1300, 2900], rng,
                                    sub_rate=0.01, ins_rate=0.0,
                                    del_rate=0.0)
    s0 = 12000
    recs.append(("del300", gstr[s0:s0 + 1000] + gstr[s0 + 1300:s0 + 2300]))
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
    return d, str(ref), str(fq), str(fa)


def _run(main, args):
    out, err = io.StringIO(), io.StringIO()
    rc = main(args, stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_native_library():
    """Both packages on the same host code.  Each loads
    build/libbioinfo1_native.so once per process.  When the test workers
    start together the library is built by several of them at once, in
    place, and a load that meets a half-written file fails; the JAX
    package then keeps its Python fallbacks for the whole process, whose
    frequency-tie order is not the reference's (--bug-compat's banned set
    and -s statistics; this failed test_bug_compat_fasta_statistics_match_jax
    at random).  The port waits for a library that loads (native.py); give
    the JAX package's loader a second attempt once it does."""
    if tnative.get_lib() is not None and jnative.get_lib() is None:
        jnative._load_attempted = False
        assert jnative.get_lib() is not None


@pytest.mark.parametrize("flags,reads", [
    (["-a", "global"], "fq"),
    (["-s"], "fa"),
])
def test_cli_output_matches_jax(inputs, flags, reads):
    _, ref, fq, fa = inputs
    args = flags + [ref, fq if reads == "fq" else fa]
    rc_t, out_t, err_t = _run(tcli.main, args + ["--profile"])
    rc_j, out_j, _ = _run(jcli.main, args)
    assert (rc_t, rc_j) == (0, 0), err_t
    assert out_t == out_j
    assert out_t.count("\t") > 20 * 11
    counters = json.loads(err_t.strip().splitlines()[-1])
    assert counters["realign_batches"] > 0, counters


def test_cli_file_output_and_resume_match_jax(inputs):
    d, ref, fq, _ = inputs
    want = d / "jax.paf"
    assert _run(jcli.main, ["-o", str(want), ref, fq])[0] == 0
    full = d / "torch.paf"
    assert _run(tcli.main, ["-o", str(full), ref, fq])[0] == 0
    assert full.read_text() == want.read_text()
    prog = json.loads((d / "torch.paf.progress").read_text())
    assert prog["completed_reads"] == prog["total_reads"] == 24

    # Resume from a checkpoint after the first rows, with a torn line past
    # it that --resume must truncate.
    rows = want.read_text().splitlines(keepends=True)
    part = d / "part.paf"
    with open(part, "w") as fh:
        fh.writelines(rows[:3])
        mark = fh.tell()
        fh.write(rows[3][:10])
    first = rows[2].split("\t")[0]
    done = next(i for i, line in enumerate(open(fq))
                if line == f"@{first}\n") // 4 + 1
    (d / "part.paf.progress").write_text(json.dumps(
        {"completed_reads": done, "total_reads": 24, "part_bytes": mark}))
    assert _run(tcli.main, ["-o", str(part), "--resume", ref, fq])[0] == 0
    assert part.read_text() == want.read_text()


@pytest.mark.parametrize("flags,env,reads,needle", [
    (["--devices", "2"], {}, "fq", "--devices 2"),
    ([], {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1",
          "JAX_NUM_PROCESSES": "1"}, "fq", "multi-process"),
])
def test_unported_flags_exit_1(inputs, monkeypatch, flags, env, reads,
                               needle):
    """Runs once refused with rc 1 and a one-line message, which now print
    what the default run prints: ``--devices 2`` (on the CPU over one
    device) since the data-parallel step was ported, and the multi-process
    variables with JAX_NUM_PROCESSES=1 (one process) since multi-process
    runs were.  The name is the refusal's."""
    _, ref, fq, fa = inputs
    args = [ref, fq if reads == "fq" else fa]
    want = _run(tcli.main, args)[1]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc, out, err = _run(tcli.main, flags + args)
    assert (rc, err) == (0, ""), needle
    assert out == want
    assert out.count("\n") > 20
