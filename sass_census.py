#!/usr/bin/env python
"""Read ``cuobjdump -sass`` listings of the port's CUDA kernels.

    python3 sass_census.py        # on a machine with nvcc and cuobjdump

A development tool, not part of the runtime package.  It counts the
instructions in a kernel's loop bodies from the machine code that was
really built (``bioinfo1_tpu_torch.kernels.build.sass()``).  The bench
uses it for one guard - the int32 probe's trip must hold the add and max
instructions its source writes - and to report what K2's cell loop issues
per cell beside what the recurrence needs.  Run as a script it builds the
kernels and prints one JSON line per kernel with the census of its
innermost loops, largest first.  Nothing here runs on the device.

A listing holds one ``Function : <mangled name>`` section per kernel; an
instruction line reads ``/*0120*/  @!P0 VIMNMX R7, R8, R7, !PT ;`` (a second
line with only the encoding follows and is skipped).  A loop is a branch
to a lower address; its body is every instruction from the target to the
branch.  A shuffle under a mask the compiler cannot prove full gets an
out-of-line handler (reached by ``BRA.DIV``, placed after the kernel's
code) that branches back into the code: those branches are no loops.

The full-matrix kernel (csrc/full_score.cu ``full_score_kernel``, one
instantiation per mode and rows per thread) holds, per strip, pair loops
that shuffle: border, interior and, in local mode, a border tail;
``full_interior_loop`` finds the interior one, whose trip computes 2 * LPT
cells.  The chain kernel (csrc/lis_chain.cu ``lis_chain_kernel``, one instantiation
per storage path of ops/chain.chain_plan) holds a cross loop, 8
predecessors a trip, and a serial loop, one column of the chunk a trip
(one REDUX, no memory access); ``chain_loops`` finds both.

The banded register kernels (csrc/band_score.cu ``band_reg_kernel``, on the
one-warp, several-warps and cluster paths) hold two pair loops, border and
interior; ``band_interior_loop`` finds the interior one, whose trip computes
2 * LPT cells.  The walk (csrc/walk_parents.cu ``walk_parents_kernel``)
holds copy loops, a tail loop that stores codes and one step loop, the
loop that reads shared memory and stores codes; ``walk_step_loop`` finds
it, one step a trip.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
from collections import Counter
from typing import Dict, List, Tuple

_INSTR = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:(@!?U?P[0-9T])\s+)?([A-Z][A-Z0-9_.]*)"
    r"\s*([^;]*);")
_MEMORY = ("LD", "ST", "ATOM", "RED")
_CONTROL = {"BRA", "BSSY", "BSYNC", "BAR", "EXIT", "NOP", "WARPSYNC", "RET",
            "CALL", "BRX", "JMP", "DEPBAR", "ERRBAR", "YIELD", "BMOV",
            "BREAK"}
# Integer and logic instructions of the per-thread datapath (the ALU pipe,
# and IMAD on the FMA pipe).  Register moves, selects and byte permutes count:
# each takes an issue slot, which is what the census measures.
_INT = {"IADD3", "IMAD", "VIADD", "VIADDMNMX", "VIMNMX", "VIMNMX3", "IMNMX",
        "ISETP", "SEL", "LOP3", "SHF", "LEA", "IABS", "PRMT", "FLO", "POPC",
        "BREV", "ISCADD", "ICMP", "MOV", "PLOP3", "BMSK", "SGXT", "I2I"}


@dataclasses.dataclass
class Instr:
    addr: int
    pred: str       # "" when unpredicated
    op: str         # opcode without modifiers (IMAD.WIDE -> IMAD)
    full_op: str
    operands: str

    @property
    def kind(self) -> str:
        """int | memory | control | uniform | other (REDUX, a warp-wide
        reduction, is other)."""
        if self.op == "REDUX":
            return "other"
        if self.op in _CONTROL:
            return "control"
        if self.op.startswith(_MEMORY):
            return "memory"
        if self.op.startswith("U") and self.op not in _INT:
            return "uniform"
        return "int" if self.op in _INT else "other"


def functions(listing: str) -> Dict[str, List[Instr]]:
    """Mangled kernel name -> its instructions, in address order."""
    out: Dict[str, List[Instr]] = {}
    cur = None
    for line in listing.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            cur = out.setdefault(s.split(":", 1)[1].strip(), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            full = m.group(3)
            cur.append(Instr(int(m.group(1), 16), m.group(2) or "",
                             full.split(".")[0], full, m.group(4).strip()))
    return out


def function(listing: str, needle: str) -> List[Instr]:
    """The one kernel whose mangled name contains ``needle``."""
    hits = [v for k, v in functions(listing).items() if needle in k]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} kernels match {needle!r}")
    return hits[0]


def loops(instrs: List[Instr]) -> List[Tuple[int, int]]:
    """(first, last) instruction indices of every loop, the last being a
    branch back to the first.  A branch to itself (the trap after EXIT) is
    no loop."""
    by_addr = {ins.addr: k for k, ins in enumerate(instrs)}

    def target(ins):
        m = re.search(r"0x([0-9a-f]+)", ins.operands)
        return int(m.group(1), 16) if m else None

    # Out-of-line handlers of divergent shuffles start at the lowest
    # BRA.DIV target; a branch back from there is a return, not a loop.
    handlers = min((target(i) for i in instrs if i.full_op == "BRA.DIV"
                    and target(i) is not None), default=None)
    out = []
    for k, ins in enumerate(instrs):
        if ins.op != "BRA" or ins.full_op == "BRA.DIV":
            continue
        if handlers is not None and ins.addr >= handlers:
            continue
        t = target(ins)
        if t is not None and t < ins.addr:
            out.append((by_addr[t], k))
    return out


def innermost(instrs: List[Instr]) -> List[Tuple[int, int]]:
    """The loops that contain no other loop."""
    ls = loops(instrs)
    return [(a, b) for a, b in ls
            if not any((c, d) != (a, b) and a <= c and d <= b
                       for c, d in ls)]


def census(instrs: List[Instr], span: Tuple[int, int]) -> dict:
    """Instruction counts of ``instrs[first..last]``: total, by kind and by
    opcode, with the span's addresses."""
    body = instrs[span[0]:span[1] + 1]
    return {"first": f"{body[0].addr:#06x}", "last": f"{body[-1].addr:#06x}",
            "instructions": len(body),
            "by_kind": dict(Counter(i.kind for i in body)),
            "by_op": dict(Counter(i.op for i in body).most_common())}


def cell_loops(listing: str, needle: str) -> List[dict]:
    """Census of every innermost loop of kernel ``needle``, largest first:
    for a DP kernel the first entries are its cell loops."""
    instrs = function(listing, needle)
    rows = [census(instrs, span) for span in innermost(instrs)]
    return sorted(rows, key=lambda r: -r["instructions"])


def band_reg_needle(parents: bool, dash_free: bool, mode: int, lpt: int,
                    multi: bool, cluster: bool = False) -> str:
    """The part of a ``band_reg_kernel`` instantiation's mangled name that
    tells it from the others (template arguments kParents, kDashFree,
    kMode, LPT, kMulti, kCluster): the one-warp path is multi = False, the
    several-warps path multi = True, the cluster path both True."""
    return (f"band_reg_kernelILb{int(parents)}ELb{int(dash_free)}E"
            f"Li{mode}ELi{lpt}ELb{int(multi)}ELb{int(cluster)}E")


def band_strip_needle(parents: bool, dash_free: bool, mode: int) -> str:
    """The part of a ``band_strip_kernel`` instantiation's mangled name
    that tells it from the others (kParents, kDashFree, kMode)."""
    return (f"band_strip_kernelILb{int(parents)}ELb{int(dash_free)}E"
            f"Li{mode}E")


def band_epoch_needle(dash_free: bool, mode: int, halo: int) -> str:
    """The part of a ``band_epoch_kernel`` instantiation's mangled name
    that tells it from the others (kDashFree, kMode, H; K2 only)."""
    return f"band_epoch_kernelILb{int(dash_free)}ELi{mode}ELi{halo}E"


def plan_needle(plan, parents: bool, dash_free: bool = True,
                mode: int = 0) -> str:
    """The needle of the kernel that serves an ``ops/band.BandPlan`` on a
    register path: ``band_reg_needle``, ``band_strip_needle`` on the strip
    path (the same pair loops inside its epochs), or ``band_epoch_needle``
    on the "epochs" path (the same pair loops, one epoch a launch)."""
    if plan.path == "strip":
        return band_strip_needle(parents, dash_free, mode)
    if plan.path == "epochs":
        return band_epoch_needle(dash_free, mode, plan.halo)
    return band_reg_needle(parents, dash_free, mode, plan.lpt,
                           plan.path != "warp", plan.path == "cluster")


def band_interior_loop(listing: str, needle: str, lpt: int) -> dict:
    """Census of a banded register kernel's interior pair loop: of its two
    largest innermost loops (border pairs, interior pairs) the smaller
    one.  A trip is one even and one odd diagonal of ``lpt`` lanes, so
    ``int_per_cell`` = integer instructions / (2 * lpt)."""
    two = cell_loops(listing, needle)[:2]
    if len(two) < 2:
        raise KeyError(f"{needle!r}: fewer than two pair loops")
    row = dict(two[1])
    row["cells_per_trip"] = 2 * lpt
    row["int_per_cell"] = row["by_kind"].get("int", 0) / (2 * lpt)
    return row


def walk_step_loop(listing: str, local: bool = False) -> dict:
    """Census of the walk kernel's step loop (template argument kLocal):
    of its innermost loops the one that reads shared memory (LDS) and
    stores codes (STG), one step a trip."""
    instrs = function(listing, f"walk_parents_kernelILb{int(local)}E")
    loops = [census(instrs, span) for span in innermost(instrs)]
    step = [row for row in loops
            if "STG" in row["by_op"] and "LDS" in row["by_op"]]
    if len(step) != 1:
        raise KeyError(f"{len(step)} step loops in the walk kernel")
    row = dict(step[0])
    row["int_per_step"] = row["by_kind"].get("int", 0)
    return row


def full_interior_loop(listing: str, mode: int, lpt: int) -> dict:
    """Census of K3's interior pair loop (csrc/full_score.cu
    ``full_score_kernel``, template arguments kMode, LPT): of the
    innermost loops that shuffle (the pair loops of a strip: border,
    interior and, in local mode, the tail) the one with the fewest
    instructions.  A trip is two diagonals of ``lpt`` rows, so
    ``int_per_cell`` = integer instructions / (2 * lpt)."""
    instrs = function(listing, f"full_score_kernelILi{mode}ELi{lpt}E")
    rows = [census(instrs, span) for span in innermost(instrs)]
    pairs = [r for r in rows if r["by_op"].get("SHFL", 0) >= 4]
    if not pairs:
        raise KeyError(f"no pair loop in K3 (mode {mode}, LPT {lpt})")
    row = dict(min(pairs, key=lambda r: r["instructions"]))
    row["pair_loops"] = len(pairs)
    row["cells_per_trip"] = 2 * lpt
    row["int_per_cell"] = row["by_kind"].get("int", 0) / (2 * lpt)
    return row


def chain_loops(listing: str) -> dict:
    """Census of the chain kernel's two DP loops for each storage path
    (template argument kPath: 0 shared, 1 state, 2 scratch, 3 wide): the
    cross loop, its largest innermost loop, whose trip tests 8 predecessors
    against each lane's column (``int_per_pair``), and the serial loop, the
    innermost loop with a REDUX and no memory access, one column a trip
    (``int_per_step``)."""
    out = {}
    for path, name in enumerate(("shared", "state", "scratch", "wide")):
        instrs = function(listing, f"lis_chain_kernelILi{path}E")
        rows = [census(instrs, span) for span in innermost(instrs)]
        cross = dict(max(rows, key=lambda r: r["instructions"]))
        cross["int_per_pair"] = cross["by_kind"].get("int", 0) / 8
        serial = [r for r in rows if "REDUX" in r["by_op"]
                  and not r["by_kind"].get("memory")]
        if len(serial) != 1:
            raise KeyError(f"{len(serial)} serial loops in the chain "
                           f"kernel ({name})")
        step = dict(serial[0])
        step["int_per_step"] = step["by_kind"].get("int", 0)
        out[name] = {"cross": cross, "serial": step}
    return out


def main() -> int:
    from bioinfo1_tpu_torch.kernels import build
    listing = build.sass()
    for name in functions(listing):
        print(json.dumps({"kernel": name,
                          "loops": cell_loops(listing, name)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
