"""Seconds of the host index build (``index.builder.build_index``, timed by
the benchmark around the call in set-up)."""


def read(ctx):
    return ctx.setup.get("index_build_s")
