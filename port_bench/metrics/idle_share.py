"""The device's idle share of the traced window: 1 less the union of the
device operations' intervals over the window's span, both from the same
profiled steps, in percent."""

LAYER = "device: one H100"
MOVES = "samples_per_s"
UNIT = "%"


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
