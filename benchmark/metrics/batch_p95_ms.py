"""95th percentile of ``Mapper.map_batch``'s wall time (the benchmark's
timer on the instance), over the window's batches that ran wholly outside
the profiled stretch."""

import numpy as np


def read(ctx):
    xs = ctx.outside_batches
    return 1e3 * float(np.percentile(xs, 95)) if xs else None
