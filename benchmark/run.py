"""Run one cell of BENCHMARK.json on this machine's cards:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result object; the numbers the check compared, each beside its limit, are
the last lines of standard error.  Exits non-zero, printing no result,
without enough CUDA cards, when the program is not in the checkout, or
when the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(cell.main(t_start=T_START))
