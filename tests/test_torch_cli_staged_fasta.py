"""Port CLI against the JAX CLI with ``--bug-compat`` on a FASTA reads file
(FASTA match nesting: the whole run takes the staged host path), with and
without ``-c``, in all three ``-a`` modes: byte-identical stdout on the
inputs of test_torch_cli_staged.py."""

import pytest

from test_torch_cli_staged import (_cpu, _one_native_library,  # noqa: F401
                                   _parity, inputs)


@pytest.mark.parametrize("cigar", [False, True], ids=["score", "c"])
@pytest.mark.parametrize("mode", ["global", "local", "semiGlobal"])
def test_bug_compat_fasta_matches_jax(inputs, mode, cigar):  # noqa: F811
    """FASTA match nesting: the whole run is staged, no fused batch."""
    flags = ["--bug-compat", "-a", mode] + (["-c"] if cigar else [])
    counters = _parity(inputs, flags, "fa")
    assert counters["t_host_s"] > 0
    assert counters["t_fused_s"] == 0
    assert counters["host_fallbacks"] == 0


def test_bug_compat_fasta_statistics_match_jax(inputs):  # noqa: F811
    _parity(inputs, ["--bug-compat", "-s"], "fa")
