"""Match budgets past 2,097,152 on the port's main path, on the CPU.

``tests/torch_golden_4mb.json`` holds a third golden recipe: the second
recipe's seeded 600 kb genome and one read of 4,200,000 bases, an
ONT-profile read of a 30 kb fragment of the genome inside random sequence.
It lands in the 6,291,456 length bucket, whose base match budget,
2,359,296, is past the 2,097,152 that K1's wide path took while it kept
q_lo in shared memory.  Its run is pinned by the sha256 of the PAF of the
port's CLI on the CPU (the plain PyTorch version of every kernel; the JAX
package's lax chain runs every step of the budget over every row, 2.36 M
steps of (16, 2.36 M), out of reach).  chip_smoke.py phase 2W holds the
port's mapper on the card to it, and to the first golden recipe's default
PAF with every match budget forced to 4,194,304.

Here: the recipe makes the read it is there for (fast); the port's CLI on
the CPU prints the pinned PAF (slow: ~1 min, ~4.4 GB of host memory); the
first golden recipe's reads at a forced budget of 4,194,304 give the
default run's PAF (slow: ~20 s, ~8 GB: the plain chain's (16, 4,194,304)
rows).
"""

import io
import os

import pytest
import torch

from bioinfo1_tpu_torch.ops import chain as ch
from bioinfo1_tpu_torch.pipeline import mapper as tmapper
from bioinfo1_tpu_torch.utils import golden

HERE = os.path.dirname(os.path.abspath(__file__))
MB4 = golden.load(os.path.join(HERE, "torch_golden_4mb.json"))
GOLDEN = golden.load(os.path.join(HERE, "torch_golden.json"))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")


def test_4mb_recipe_read_takes_a_budget_past_the_old_wide_limit():
    """The read: 4,200,000 bases, the 30 kb fragment's read whole inside
    random flanks, in the 6,291,456 bucket, whose base budget 2,359,296 is
    past 2^21 and taken by K1's wide path; the genome is the second
    recipe's."""
    genome, recs = golden.records(MB4["recipe"])
    ultra = golden.load(os.path.join(HERE, "torch_golden_ultra.json"))
    assert genome == golden.records(dict(ultra["recipe"], lengths=[]))[0]
    ((name, seq),) = golden.run_records(recs, MB4["runs"][0])
    (emb,) = MB4["recipe"]["embedded"]
    assert name == emb["name"] and len(seq) == emb["length"] == 4200000
    assert set(seq) == set("ACGT")
    floor = tmapper.MapperConfig().k + tmapper.MapperConfig().w - 1
    cap = tmapper._bucket_cap(len(seq), floor)
    base = -(-3 * cap // (8 * 128)) * 128
    assert (cap, base) == (6291456, 2359296) and base > 2 ** 21
    assert ch.chain_plan(base).path == "wide"


@pytest.mark.slow
def test_port_cli_prints_the_pinned_4mb_paf(tmp_path):
    from bioinfo1_tpu_torch import cli
    (run,) = MB4["runs"]
    ref, reads = golden.write_inputs(MB4["recipe"], str(tmp_path), run)
    out, err = io.StringIO(), io.StringIO()
    rc = cli.main(run["flags"] + [ref, reads], stdout=out, stderr=err)
    assert rc == 0, err.getvalue()
    assert len(out.getvalue().splitlines()) == 1
    assert golden.sha256(out.getvalue()) == run["sha256"]


@pytest.mark.slow
def test_golden_reads_at_a_forced_budget_give_the_default_paf():
    """Every fused call at a match budget of 4,194,304 (keep_cap in the
    lookup grows with the budget): the default run's PAF, no fault, no
    overflow retry."""
    import bioinfo1_tpu_torch as port
    genome, recs = golden.records(GOLDEN["recipe"])
    mapper = port.Mapper([(GOLDEN["recipe"]["ref_name"], genome)],
                         port.MapperConfig(initial_match_budget=1 << 22),
                         device=torch.device("cpu"))
    lines = mapper.map_records(recs)
    (want,) = [r["sha256"] for r in GOLDEN["runs"]
               if r["flags"] == ["-a", "global"]]
    assert golden.sha256("".join(line + "\n" for line in lines)) == want
    assert mapper.counters.faults == 0
    assert mapper.counters.budget_retries == 0
