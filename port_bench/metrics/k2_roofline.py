"""K2, the fused SSIM+L1 reprojection error (`ops/cuda/reprojection.py`,
`csrc/reprojection.cu`): the share of its roofline, the least time of the
step's errors (the automask's identity errors and, with
`fused_reprojection`, the per-scale pred errors; `harness/work.py::k2`)
over the device time of its launches."""

from port_bench.harness import work

LAYER = "kernels: K1-K3 (ops/cuda, csrc)"
MOVES = "samples_per_s"
UNIT = "%"
PATTERNS = ("reprojection_error_kernel",)


def read(ctx):
    return work.roofline_share(ctx, PATTERNS, work.k2)
