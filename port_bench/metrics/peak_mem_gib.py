"""The most device memory allocated during the window
(`torch.cuda.max_memory_allocated()` after a reset before it), in GiB."""

UNIT = "GiB"


def read(ctx):
    return ctx.window_peak_bytes / 2**30 if ctx.window_peak_bytes else None
