"""Float8 convolutions for the control of a bf16 configuration: inside
`fp8_convolutions()` every `nn.Conv2d` rounds its input and its kernel to
float8 e4m3 (one scale per tensor, the tensor's largest magnitude at e4m3's
largest finite value, 448) before the convolution, which then runs as it
would (in bf16 under autocast), as a float8 GEMM with a wider accumulator
does. The gradient passes the rounding straight through."""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 at one scale, in `x`'s dtype; the
    gradient is the identity."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


@contextlib.contextmanager
def fp8_convolutions():
    original = nn.Conv2d._conv_forward

    def conv_forward(self, input, weight, bias):
        return original(self, round_fp8(input), round_fp8(weight), bias)

    nn.Conv2d._conv_forward = conv_forward
    try:
        yield
    finally:
        nn.Conv2d._conv_forward = original
