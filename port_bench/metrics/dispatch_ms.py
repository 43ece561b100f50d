"""Host time of each `Run.step` call in the window (`engine/trainer.py::
Run.step` -> `engine/train_steps.py::train_step`, which returns once its
work is queued), averaged over the window's steps. Where it is close to the
step interval, the host paces the step."""

import statistics

LAYER = "step: Run.step -> train_step"
MOVES = "samples_per_s"
UNIT = "ms"


def read(ctx):
    xs = ctx.window.dispatch_s
    return 1e3 * statistics.fmean(xs) if xs else None
