"""Share of the traced stretch in which the caller of
``Mapper.map_records_iter`` waited for a batch (its ``iter.wait`` scope, on
the thread that runs the window)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.seconds <= 0:
        return None
    return 100.0 * t.scope_s("iter.wait", t.main_tid) / t.seconds
