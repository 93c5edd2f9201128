"""Certificate misses sent to a realign pass (``MapperCounters.
realign_reroutes``) per 1,000 reads mapped in the window."""


def read(ctx):
    reads = ctx.window["reads"]
    return 1e3 * ctx.window["realign_reroutes"] / reads if reads else None
