"""Device launches per profiled step: the trace's kernels (copies and fills
of memory not counted), over the profiled steps."""

LAYER = "step: Run.step -> train_step"
MOVES = "samples_per_s"
UNIT = "kernels"

NOT_KERNELS = ("memcpy", "memset")


def read(ctx):
    if ctx.trace is None:
        return None
    n = sum(1 for op in ctx.trace.ops if not op.name.lower().startswith(NOT_KERNELS))
    return n / ctx.trace.steps
