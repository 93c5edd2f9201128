"""The check's control: the reference put in the program's place, with its
DP held to a band of ``check.control_band`` lanes and no certificate (the
banded score taken as final: the step that would tempt a faster mapper).
It has to come out not correct.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

builds each seed's genome and pool as a run does, draws the run's sample
(every pool read counts as finished in the window), and prints per seed
the check's numbers for the control's rows, one JSON line each.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import cell, simulate  # noqa: E402


def reading(c: cell.Cell, seed: int, device) -> dict:
    """The check's numbers when the control's rows stand for the program's
    (every pool read finished once)."""
    genome = simulate.make_genome(c.config["genome"], seed)
    pool = [s for _, s in simulate.make_pool(genome, c.traffic,
                                             simulate.rng_for(seed, 1))]
    P = len(pool)
    pick = cell.sample(c, seed, pool, P)
    ctl = cell.reference_rows(c, genome, pool, pick, device,
                              int(c.config["check"]["control_band"]))
    lines = [f"r{p}.0\t{row}" for p, row in ctl.items() if row is not None]
    return cell.compare(cell.reference_rows(c, genome, pool, pick, device),
                        lines, P, P)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    c = cell.Cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        r = reading(c, seed, dev)
        print(json.dumps({"workload": c.name, "seed": seed,
                          "correct": r.pop("_correct"), "check": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
