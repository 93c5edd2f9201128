"""The JAX package's CLI reproduces the pinned hashes of reads past 131 kb.

``tests/torch_golden_ultra.json`` holds a second golden recipe: a read of
~150 kb (the 196,608 length bucket, base match budget 73,728) and one of
~250 kb (the 262,144 bucket, 98,304), each a run of its own.  These budgets
are past the 16-bit index of the narrow chain kernels; the port maps the
reads on the card through K1's wide path, and chip_smoke.py phase 2U holds
its PAF to the hashes.  The runs pinned by the JAX CLI (``pinned_by``
"jax_cli") were hashed from it on the CPU; here it reruns each and must
print the same bytes, so the pin stays the JAX package's output.  Slow:
on the CPU the JAX CLI's fused step faults on the ~150 kb read after ~2.5
min (the Pallas banded kernel in interpret mode asks for 128 GiB) and its
host path takes ~1 h more (its lax chain runs every step of the budget
over every row).  The ~250 kb read had not finished after 38 min there,
so the port's CLI on the CPU pins it instead (test_torch_golden_ultra.py).
"""

import io
import os

import pytest

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu_torch.utils import golden

ULTRA = golden.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "torch_golden_ultra.json"))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")
    monkeypatch.setenv("BIOINFO1_BAND_CACHE", "0")


@pytest.mark.slow
@pytest.mark.parametrize("run", [r for r in ULTRA["runs"]
                                 if r["pinned_by"] == "jax_cli"],
                         ids=lambda r: r["name"])
def test_jax_cli_prints_the_pinned_ultra_paf(tmp_path, run):
    ref, reads = golden.write_inputs(ULTRA["recipe"], str(tmp_path), run)
    out, err = io.StringIO(), io.StringIO()
    rc = jcli.main(run["flags"] + [ref, reads], stdout=out, stderr=err)
    assert rc == 0, err.getvalue()
    assert golden.sha256(out.getvalue()) == run["sha256"], run["name"]
