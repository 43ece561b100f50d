"""Training throughput: rows of the training batch (`batch` a step; the
semi-supervised step carries as many unlabeled rows beside them) trained in
the window, over the window's wall time, from the first step's feed to the
synchronise after the last step. Host clock."""

UNIT = "samples/s"


def read(ctx):
    w = ctx.window
    return w.batch * w.steps / w.seconds
