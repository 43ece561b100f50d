"""Device ms per profiled step in convolutions and GEMMs and in cuDNN's
NCHW <-> NHWC transposes (the kernel classes of `harness/trace.py`)."""

LAYER = "model: models/*"
MOVES = "samples_per_s"
UNIT = "ms"

CLASSES = ("convolutions / GEMMs", "cuDNN NCHW <-> NHWC transposes")


def read(ctx):
    if ctx.trace is None:
        return None
    by = ctx.trace.by_class()
    if not any(c in by for c in CLASSES):
        return None
    return 1e3 * sum(by[c][0] for c in CLASSES if c in by)
