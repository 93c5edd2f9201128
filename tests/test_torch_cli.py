"""Port CLI against the JAX CLI: byte-identical output.

A ~40 kb simulated genome and ~24 ONT-profile reads of 200-3000 bp (one
with a 300-base deletion, so the realign pass runs) go through
``bioinfo1_tpu_torch.cli.main`` on the CPU and ``bioinfo1_tpu.cli.main``;
stdout, or the -o file, must be identical.  Covers FASTA and FASTQ reads,
global mode, -s, and -o with --resume (test_torch_cli_modes.py covers the
local and semiGlobal modes and --bug-compat, test_torch_cli_cigar*.py the
-c runs).  What the port does not run yet must exit 1 with its message:
-c without an exactness certificate, FASTA match nesting, more than one
device, a multi-process run.
"""

import io
import json

import numpy as np
import pytest

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu.utils import simulate
from bioinfo1_tpu_torch import cli as tcli


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
    (["-c", "-g", "1"], {}, "fq", "-c with -a global -g 1"),
    (["-c", "-a", "local", "-g", "1"], {}, "fq", "-c with -a local -g 1"),
    (["--devices", "2"], {}, "fq", "--devices 2"),
    ([], {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1"}, "fq", "multi-process"),
    (["--bug-compat"], {}, "fa", "FASTA match nesting"),
])
def test_unported_flags_exit_1(inputs, monkeypatch, flags, env, reads,
                               needle):
    _, ref, fq, fa = inputs
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc, out, err = _run(tcli.main, flags + [ref, fq if reads == "fq" else fa])
    assert rc == 1
    assert out == ""
    assert needle in err and "not yet ported" in err
    assert len(err.strip().splitlines()) == 1
