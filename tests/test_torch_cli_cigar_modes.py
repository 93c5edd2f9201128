"""Port CLI against the JAX CLI with -c in local and semiGlobal mode, and
with --bug-compat (FASTQ reads, local mode: the reference's local
target_begin quirk): byte-identical stdout on the inputs of
test_torch_cli_cigar.py, in a file of its own so the two halves run on
different test workers.  Every case takes the parents realign pass."""

import pytest

from test_torch_cli import _cpu  # noqa: F401  (fixture)
from test_torch_cli_cigar import check_cigar_run, cigar_inputs  # noqa: F401


@pytest.mark.parametrize("flags", [
    ["-c", "-a", "local"],
    ["-c", "-a", "semiGlobal"],
    ["-c", "--bug-compat", "-a", "local"],
])
def test_cli_cigar_mode_matches_jax(cigar_inputs, flags):  # noqa: F811
    check_cigar_run(cigar_inputs, flags, realign=True)
