"""Thread-CPU milliseconds a batch spent inside its ``fused`` spans (the
program's batch record), the mean over the batches that ran wholly inside
the traced stretch; beside ``fused_ms_per_batch``, which is wall time."""

from benchmark import batches


def read(ctx):
    got = batches.in_stretch(ctx)
    if not got:
        return None
    cpu = [getattr(r.spans.get("fused"), "cpu_ns", 0) for _e, r in got]
    return sum(cpu) / len(cpu) / 1e6
