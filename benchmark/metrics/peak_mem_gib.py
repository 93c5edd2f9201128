"""``torch.cuda.max_memory_allocated`` over the window, in GiB, on the
fullest card the mapper uses."""


def read(ctx):
    if not ctx.window_peak_bytes:
        return None
    return max(ctx.window_peak_bytes.values()) / 2 ** 30
