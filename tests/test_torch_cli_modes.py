"""Port CLI against the JAX CLI in local and semiGlobal mode, and with
--bug-compat on FASTQ reads: byte-identical stdout on the inputs of
test_torch_cli.py (kept in a file of its own so the two halves run on
different test workers)."""

import json

import pytest

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu_torch import cli as tcli
from test_torch_cli import (_cpu, _one_native_library, _run,  # noqa: F401
                            inputs)


@pytest.mark.parametrize("flags", [
    ["-a", "local"],
    ["-a", "semiGlobal"],
    ["--bug-compat", "-a", "semiGlobal"],
])
def test_cli_mode_output_matches_jax(inputs, flags):  # noqa: F811
    _, ref, fq, _ = inputs
    args = flags + [ref, fq]
    rc_t, out_t, err_t = _run(tcli.main, args + ["--profile"])
    rc_j, out_j, _ = _run(jcli.main, args)
    assert (rc_t, rc_j) == (0, 0), err_t
    assert out_t == out_j
    assert out_t.count("\t") > 20 * 11
    counters = json.loads(err_t.strip().splitlines()[-1])
    assert counters["realign_batches"] > 0, counters
