"""Device ms per profiled step in BatchNorm kernels (the class of
`harness/trace.py`)."""

LAYER = "model: models/*"
MOVES = "samples_per_s"
UNIT = "ms"


def read(ctx):
    if ctx.trace is None:
        return None
    by = ctx.trace.by_class()
    return 1e3 * by["BatchNorm"][0] if "BatchNorm" in by else None
