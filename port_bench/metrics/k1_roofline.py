"""K1, the multi-grid bilinear warp (`ops/cuda/warp.py`, `csrc/warp.cu`):
the share of its roofline, the least time of the step's warps (every
photometric pass, every source frame at every scale; `harness/work.py::k1`)
over the device time of the launches that did them (the warp and its
interleave of the RGB frame)."""

from port_bench.harness import work

LAYER = "kernels: K1-K3 (ops/cuda, csrc)"
MOVES = "samples_per_s"
UNIT = "%"
PATTERNS = ("warp_bilinear_nchw_kernel", "interleave_rgb_kernel")


def read(ctx):
    return work.roofline_share(ctx, PATTERNS, work.k1)
