"""Set-up: from the process's start (the first line of `run.py`) to the
first timed step's feed: torch's import, the kernels' build or load, the
run's build, the weights, the ring, the checked steps and the warm-up
step. Host clock."""

UNIT = "s"


def read(ctx):
    return ctx.setup_s
