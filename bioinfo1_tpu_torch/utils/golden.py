"""The pinned golden workload: a seeded genome and read set, the CLI runs
over it, and the sha256 of each run's PAF.

The recipe and the hashes are one JSON file (``tests/torch_golden.json``),
the hashes made once from the JAX package's CLI.  A change that must leave
the output alone shows it by rerunning the CLI on the recipe and getting
the same hashes, on the CPU (``tests/test_torch_golden.py``) or on the card
(``chip_smoke.py`` phase 2a), without the JAX package.

The file holds ``recipe`` (what ``write_inputs`` makes) and ``runs``, a
list of ``{"name", "flags", "sha256"}``; a run is the CLI with its flags on
the recipe's reference and reads, and its hash is that of its stdout.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Tuple

import numpy as np

from bioinfo1_tpu_torch.utils import simulate as sim


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def records(recipe: dict) -> Tuple[str, List[Tuple[str, str]]]:
    """(genome, read records) of the recipe: a random genome, ONT-profile
    reads of ``lengths``, near-exact reads of ``accurate_lengths`` and one
    read with a deletion (``deletion``: start, length kept on each side,
    bases left out), all from one generator seeded with ``seed``."""
    rng = np.random.default_rng(recipe["seed"])
    genome = sim.random_genome(recipe["genome_len"], rng)
    recs = sim.simulate_reads(genome, recipe["lengths"], rng)
    recs += sim.simulate_reads(genome, recipe["accurate_lengths"], rng,
                               sub_rate=recipe["accurate_sub_rate"],
                               ins_rate=0.0, del_rate=0.0)
    d = recipe["deletion"]
    g = genome.tobytes().decode("latin1")
    s0, keep, gap = d["start"], d["keep"], d["gap"]
    recs.append((d["name"], g[s0:s0 + keep]
                 + g[s0 + keep + gap:s0 + 2 * keep + gap]))
    return g, recs


def write_inputs(recipe: dict, directory: str) -> Tuple[str, str]:
    """Writes the recipe's reference (FASTA) and reads (FASTQ) into
    ``directory``; returns their paths."""
    genome, recs = records(recipe)
    os.makedirs(directory, exist_ok=True)
    ref = os.path.join(directory, "golden_ref.fa")
    reads = os.path.join(directory, "golden_reads.fq")
    with open(ref, "w") as fh:
        fh.write(f">{recipe['ref_name']}\n{genome}\n")
    with open(reads, "w") as fh:
        for name, s in recs:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    return ref, reads


def sha256(paf: str) -> str:
    return hashlib.sha256(paf.encode()).hexdigest()
