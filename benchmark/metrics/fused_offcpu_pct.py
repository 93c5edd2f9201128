"""Share of the batch threads' wall time in ``fused.pack``, ``fused.step``
and ``fused.adapt`` that their thread spent off a core, 100 x (wall - CPU)
/ wall summed over the batches that ran wholly inside the traced stretch
(the program's batch records).  These spans make no call that waits for
the card's results, so off a core is the wait for the interpreter lock or
the scheduler, and, where the card is saturated, a launch's wait for room
in the runtime's launch queue.  ``fused.upload`` and ``fused.fetch`` wait
on the card and are left out."""

from benchmark import batches

SPANS = ("fused.pack", "fused.step", "fused.adapt")


def read(ctx):
    rows = [r.spans[n] for _e, r in batches.in_stretch(ctx) for n in SPANS
            if n in r.spans]
    wall = sum(x.wall_ns for x in rows)
    if wall <= 0:
        return None
    return 100.0 * (wall - sum(x.cpu_ns for x in rows)) / wall
