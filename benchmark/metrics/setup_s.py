"""Seconds from the process's start to the window's start: imports, CUDA,
genome and pool, the host index build, the upload, the warm passes (and,
in a fresh checkout's first run, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
