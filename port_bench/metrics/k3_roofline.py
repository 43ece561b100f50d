"""K3, the fused error's analytic gradient (`ops/cuda/reprojection.py`,
`csrc/reprojection.cu`; only with `fused_reprojection`): the share of its
roofline, the least time of the step's pred-error gradients
(`harness/work.py::k3`) over the device time of its launches."""

from port_bench.harness import work

LAYER = "kernels: K1-K3 (ops/cuda, csrc)"
MOVES = "samples_per_s"
UNIT = "%"
PATTERNS = ("reprojection_error_grad_kernel",)


def read(ctx):
    return work.roofline_share(ctx, PATTERNS, work.k3)
