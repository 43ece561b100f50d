"""The 90th percentile of every interval between consecutive step ends in
the window, each step end a CUDA event recorded after the step's dispatch
(stamped by the device, so nothing synchronises per step); the first
interval starts at an event recorded before the first step's feed."""

import statistics

UNIT = "ms"


def read(ctx):
    xs = ctx.window.intervals_ms
    if len(xs) < 2:
        return None
    return statistics.quantiles(xs, n=10, method="inclusive")[-1]
