"""Port CLI against the JAX CLI where no exactness certificate exists:
score-only with ``-g 1`` in global mode, and ``-a local -g 1`` /
``-a semiGlobal -g 1`` (ops/band.certify certifies nothing at gap > 0).
Every bucket then takes the full-matrix DP (kernel K3's plain version on
the CPU) in the fused step and no read needs a realign pass.  Stdout must
be byte-identical on the inputs of test_torch_cli.py."""

import json

import pytest

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu_torch import cli as tcli
from test_torch_cli import _cpu, _run, inputs  # noqa: F401  (fixtures)


@pytest.mark.parametrize("flags", [
    ["-g", "1"],
    ["-a", "local", "-g", "1"],
    ["-a", "semiGlobal", "-g", "1"],
], ids=["global", "local", "semiGlobal"])
def test_cli_without_certificate_matches_jax(inputs, flags):  # noqa: F811
    _, ref, fq, _ = inputs
    args = flags + [ref, fq]
    rc_t, out_t, err_t = _run(tcli.main, args + ["--profile"])
    rc_j, out_j, _ = _run(jcli.main, args)
    assert (rc_t, rc_j) == (0, 0), err_t
    assert out_t == out_j
    assert out_t.count("\n") >= 20
    counters = json.loads(err_t.strip().splitlines()[-1])
    assert counters["batches"] > 0 and counters["t_fused_s"] > 0, counters
    assert counters["realign_batches"] == 0, counters
    assert counters["cert_total"] == 0, counters
