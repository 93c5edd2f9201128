"""The second golden recipe (``tests/torch_golden_ultra.json``): reads past
131 kb, whose match budgets take K1's wide path.

Its recipe makes a seeded 600 kb genome and a ~150 kb and a ~250 kb read,
each a run of its own, pinned by the sha256 of a CLI's PAF on the CPU (the
JAX package's where it finishes, ``test_torch_golden_ultra_jax.py``; the
port's plain version for the ~250 kb read).  Here: each run's read lands in
the length bucket it is there for, with a base match budget past 65,535
(fast); and the port's CLI on the CPU prints every pinned PAF (slow: the
plain banded DP of the realign pass at bands of 131,072-262,144 lanes,
~10-30 min a read).  On the card chip_smoke.py phase 2U holds the port's
mapper to the same hashes.
"""

import io
import os

import pytest

from bioinfo1_tpu_torch.ops import chain as ch
from bioinfo1_tpu_torch.pipeline import mapper as tmapper
from bioinfo1_tpu_torch.utils import golden

ULTRA = golden.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "torch_golden_ultra.json"))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")


def test_ultra_recipe_reads_take_the_wide_budgets(tmp_path):
    """Each run's read lands in the length bucket it is there for, whose
    base match budget K1 runs on its wide path, and its FASTQ holds it
    alone."""
    genome, recs = golden.records(ULTRA["recipe"])
    assert len(genome) == ULTRA["recipe"]["genome_len"]
    floor = tmapper.MapperConfig().k + tmapper.MapperConfig().w - 1
    caps = []
    for run in ULTRA["runs"]:
        assert run["pinned_by"] in ("jax_cli", "port_cpu")
        (rec,) = golden.run_records(recs, run)
        cap = tmapper._bucket_cap(len(rec[1]), floor)
        base = -(-3 * cap // (8 * 128)) * 128
        assert ch.chain_plan(base).path == "wide"
        caps.append((cap, base))
        _, reads = golden.write_inputs(ULTRA["recipe"], str(tmp_path), run)
        name, seq = rec
        with open(reads) as fh:
            assert fh.read() == f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n"
    assert caps == [(196608, 73728), (262144, 98304)]


@pytest.mark.slow
@pytest.mark.parametrize("run", ULTRA["runs"], ids=lambda r: r["name"])
def test_port_cli_prints_the_pinned_ultra_paf(tmp_path, run):
    from bioinfo1_tpu_torch import cli
    ref, reads = golden.write_inputs(ULTRA["recipe"], str(tmp_path), run)
    out, err = io.StringIO(), io.StringIO()
    rc = cli.main(run["flags"] + [ref, reads], stdout=out, stderr=err)
    assert rc == 0, err.getvalue()
    assert golden.sha256(out.getvalue()) == run["sha256"], run["name"]
