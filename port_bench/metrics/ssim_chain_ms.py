"""Device ms per profiled step in reflection pads and average pools: the
SSIM chain of the photometric loss outside K2/K3 and the smoothness term
(`ops/photometric.py`, `ops/image.py`)."""

LAYER = "photometric loss: ops/photometric.py, ops/image.py"
MOVES = "samples_per_s"
UNIT = "ms"

CLASS = "reflection pads + avg-pools"


def read(ctx):
    if ctx.trace is None:
        return None
    by = ctx.trace.by_class()
    return 1e3 * by[CLASS][0] if CLASS in by else None
