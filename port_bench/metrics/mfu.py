"""The whole step's share of the card's dense peak for the precision the
configuration computes in (TF32 495, bf16 989 TFLOP/s on an H100 SXM at
700 W; the card's power limit is in the result's `device`): the model FLOPs
a step requires (`harness/flops.py`, counted on the meta device over the
plain reference) times the window's steps, over the window's wall time."""

LAYER = "device: one H100"
MOVES = "samples_per_s"
UNIT = "%"


def read(ctx):
    if ctx.peaks is None or ctx.precision not in ctx.peaks:
        return None
    w = ctx.window
    return 100.0 * ctx.step_flops() * w.steps / w.seconds / ctx.peaks[ctx.precision]
