"""The JAX package's CLI reproduces the pinned golden hashes.

The hashes in ``tests/torch_golden.json`` were made once from the JAX
package's CLI on the recipe there; this test reruns that CLI on the CPU
and must get them again, so the pin stays the JAX package's output.  It is
the only golden test that imports JAX (``test_torch_golden.py`` holds the
port's CLI to the same hashes without it).  The recipe's files come from
the port's copy of the simulator, held equal to the JAX package's by
``test_torch_host_modules.py``.
"""

import io
import os

import pytest

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu_torch.utils import golden

GOLDEN = golden.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "torch_golden.json"))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return golden.write_inputs(GOLDEN["recipe"],
                               str(tmp_path_factory.mktemp("golden_jax")))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")


@pytest.mark.parametrize("run", GOLDEN["runs"], ids=lambda r: r["name"])
def test_jax_cli_prints_the_pinned_paf(inputs, run):
    ref, reads = inputs
    out, err = io.StringIO(), io.StringIO()
    rc = jcli.main(run["flags"] + [ref, reads], stdout=out, stderr=err)
    assert rc == 0, err.getvalue()
    assert golden.sha256(out.getvalue()) == run["sha256"], run["flags"]
