"""Host milliseconds of the fused step (``MapperCounters.t_fused_s``:
dispatch and fetch, summed over the batch threads) per batch, outside the
profiled stretch."""


def read(ctx):
    n = ctx.outside["batches"]
    return 1e3 * ctx.outside["t_fused_s"] / n if n else None
