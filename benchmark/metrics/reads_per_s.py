"""Reads whose PAF lines ``Mapper.map_records_iter`` yielded by the
window's deadline, over the window's seconds."""


def read(ctx):
    return ctx.reads_in_window / ctx.seconds
