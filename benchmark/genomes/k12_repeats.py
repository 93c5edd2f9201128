"""A genome of E. coli K-12 MG1655's repeat census on a random backbone.

A frozen copy of ``bioinfo1_tpu_torch/utils/simulate.py``'s
``repeat_genome`` (the same draws in the same order, so one seed gives the
same genome), so that a later change to the program cannot move it.  A
uniform random genome never fires the mapper's repeat machinery (the
frequency ban, the match budget's overflow ladder, repeat-dense chains);
K-12's repeats do.  Planted into uniform random bases:

* three insertion-sequence-like units (IS1 / IS2 / IS5 analogs), each in
  ``is_elements // 3`` copies of ``is_len`` bases;
* ``rrn_operons`` rRNA-operon-like copies of ``rrn_len`` bases, nearly
  identical (``rrn_divergence``);
* ``tandem_loci`` loci of a ``tandem_unit``-base unit repeated
  ``tandem_copies`` times back to back (REP / BIME-like).

Each copy is mutated at ``divergence`` and lands on either strand at a
uniform position; later copies overwrite earlier ones where they overlap.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"CATG", dtype=np.uint8)


def make(n: int, rng: np.random.Generator, is_elements: int = 40,
         is_len: int = 1300, rrn_operons: int = 7, rrn_len: int = 5000,
         tandem_loci: int = 60, tandem_unit: int = 120,
         tandem_copies: int = 12, divergence: float = 0.01,
         rrn_divergence: float = 0.002) -> np.ndarray:
    """``n`` bases (uint8) with the census above."""
    g = BASES[rng.integers(0, 4, n)]
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ATGC", b"TACG"):
        comp[a] = b

    def mutate(unit, div=None):
        u = unit.copy()
        d = divergence if div is None else div
        pos = rng.integers(0, len(u), max(1, int(len(u) * d)))
        u[pos] = BASES[rng.integers(0, 4, len(pos))]
        return u

    def plant(unit, copies, div=None):
        for _ in range(copies):
            u = mutate(unit, div)
            if rng.random() < 0.5:                       # either strand
                u = comp[u[::-1]]
            start = int(rng.integers(0, max(1, n - len(u))))
            g[start:start + len(u)] = u[: n - start]

    for _ in range(3):                                   # IS1/IS2/IS5-like
        plant(BASES[rng.integers(0, 4, is_len)], max(1, is_elements // 3))
    plant(BASES[rng.integers(0, 4, rrn_len)], rrn_operons,
          div=rrn_divergence)
    for _ in range(tandem_loci):
        unit = BASES[rng.integers(0, 4, tandem_unit)]
        arr = np.concatenate([mutate(unit) for _ in range(tandem_copies)])
        start = int(rng.integers(0, max(1, n - len(arr))))
        g[start:start + len(arr)] = arr[: n - start]
    return g
