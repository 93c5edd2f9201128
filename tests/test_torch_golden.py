"""The port's CLI on the CPU against the pinned golden hashes.

``tests/torch_golden.json`` holds the recipe of a seeded genome and read
set (``bioinfo1_tpu_torch/utils/golden.py``) and the sha256 of the PAF of
eight CLI runs on it: ``-a global``, ``local`` and ``semiGlobal``, each
score-only and with ``-c``; ``-g 1`` (no certificate: the full-matrix score
on every bucket); ``-c -g 1`` (the staged host path).  The hashes were made
from the JAX package's CLI (``test_torch_golden_jax.py`` holds it to them).
Here the port's CLI must print the same bytes without the JAX package, and
``map_all`` on the recipe the default run's PAF.  About 3.5 min of CPU
time in all: the realign passes' plain banded DP dominates.
"""

import io
import os

import pytest
import torch

from bioinfo1_tpu_torch.utils import golden

GOLDEN = golden.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "torch_golden.json"))
N_READS = (len(GOLDEN["recipe"]["lengths"])
           + len(GOLDEN["recipe"]["accurate_lengths"]) + 1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return golden.write_inputs(GOLDEN["recipe"],
                               str(tmp_path_factory.mktemp("golden")))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")


@pytest.mark.parametrize("run", GOLDEN["runs"], ids=lambda r: r["name"])
def test_port_cli_prints_the_pinned_paf(inputs, run):
    from bioinfo1_tpu_torch import cli
    ref, reads = inputs
    out, err = io.StringIO(), io.StringIO()
    rc = cli.main(run["flags"] + [ref, reads], stdout=out, stderr=err)
    assert rc == 0, err.getvalue()
    assert len(out.getvalue().splitlines()) == N_READS
    assert golden.sha256(out.getvalue()) == run["sha256"], run["flags"]


def test_map_all_prints_the_default_runs_paf():
    import bioinfo1_tpu_torch as port
    genome, recs = golden.records(GOLDEN["recipe"])
    lines = port.map_all([(GOLDEN["recipe"]["ref_name"], genome)], recs,
                         port.MapperConfig(), device=torch.device("cpu"))
    (want,) = [r["sha256"] for r in GOLDEN["runs"]
               if r["flags"] == ["-a", "global"]]
    assert golden.sha256("".join(line + "\n" for line in lines)) == want


def test_recipe_makes_the_pinned_inputs(inputs):
    """The recipe's files: its genome under its name, and every read as
    a FASTQ record, the deletion read last."""
    ref, reads = inputs
    genome, recs = golden.records(GOLDEN["recipe"])
    with open(ref) as fh:
        assert fh.read() == f">{GOLDEN['recipe']['ref_name']}\n{genome}\n"
    with open(reads) as fh:
        lines = fh.read().splitlines()
    assert len(recs) == N_READS == len(lines) // 4
    assert [line[1:] for line in lines[::4]] == [n for n, _ in recs]
    assert lines[1::4] == [s for _, s in recs]
    d = GOLDEN["recipe"]["deletion"]
    assert recs[-1] == (d["name"], genome[d["start"]:d["start"] + d["keep"]]
                        + genome[d["start"] + d["keep"] + d["gap"]:
                                 d["start"] + 2 * d["keep"] + d["gap"]])
    assert sum(len(s) <= 512 for _, s in recs) >= 4    # a band-0 bucket
