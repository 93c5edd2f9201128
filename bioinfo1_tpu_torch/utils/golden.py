"""The pinned golden workload: a seeded genome and read set, the CLI runs
over it, and the sha256 of each run's PAF.

The recipe and the hashes are one JSON file (``tests/torch_golden.json``),
the hashes made once from the JAX package's CLI.  A change that must leave
the output alone shows it by rerunning the CLI on the recipe and getting
the same hashes, on the CPU (``tests/test_torch_golden.py``) or on the card
(``chip_smoke.py`` phase 2a), without the JAX package.

The file holds ``recipe`` (what ``write_inputs`` makes) and ``runs``, a
list of ``{"name", "flags", "sha256"}``; a run is the CLI with its flags on
the recipe's reference and reads, and its hash is that of its stdout.  A
run with ``"reads"`` (indices into the recipe's reads) maps those alone
(``tests/torch_golden_ultra.json``: one read of ~150 kb and one of ~250 kb,
each a run of its own; ``tests/torch_golden_4mb.json``: one read of ~4.2 Mb,
a genomic fragment inside random sequence).
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
    reads of ``lengths``, then, where the recipe names them, near-exact
    reads of ``accurate_lengths``, one read with a deletion (``deletion``:
    start, length kept on each side, bases left out) and reads of random
    sequence around an ONT-profile read of the genome (``embedded``: name,
    total length, fragment length; the random flanks split what the
    fragment's read leaves), all from one generator seeded with ``seed``."""
    rng = np.random.default_rng(recipe["seed"])
    genome = sim.random_genome(recipe["genome_len"], rng)
    recs = sim.simulate_reads(genome, recipe["lengths"], rng)
    g = genome.tobytes().decode("latin1")
    if "accurate_lengths" in recipe:
        recs += sim.simulate_reads(genome, recipe["accurate_lengths"], rng,
                                   sub_rate=recipe["accurate_sub_rate"],
                                   ins_rate=0.0, del_rate=0.0)
    if "deletion" in recipe:
        d = recipe["deletion"]
        s0, keep, gap = d["start"], d["keep"], d["gap"]
        recs.append((d["name"], g[s0:s0 + keep]
                     + g[s0 + keep + gap:s0 + 2 * keep + gap]))
    for e in recipe.get("embedded", ()):
        (_, core), = sim.simulate_reads(genome, [e["fragment"]], rng)
        left = (e["length"] - len(core)) // 2
        right = e["length"] - len(core) - left
        recs.append((e["name"],
                     sim.random_genome(left, rng).tobytes().decode("latin1")
                     + core
                     + sim.random_genome(right, rng).tobytes().decode(
                         "latin1")))
    return g, recs


def run_records(recs: List[Tuple[str, str]],
                run: dict) -> List[Tuple[str, str]]:
    """The records of ``recs`` (the recipe's) that a run maps: its
    ``reads``, else all."""
    return [recs[i] for i in run["reads"]] if "reads" in run else recs


def write_inputs(recipe: dict, directory: str,
                 run: dict = None) -> Tuple[str, str]:
    """Writes the recipe's reference (FASTA) and reads (FASTQ; with ``run``,
    the reads that run maps) into ``directory``; returns their paths."""
    genome, recs = records(recipe)
    if run is not None:
        recs = run_records(recs, run)
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
