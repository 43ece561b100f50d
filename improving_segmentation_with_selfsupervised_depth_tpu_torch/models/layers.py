"""Shared model building blocks (NCHW), in the reference state_dict layout.

Port of the JAX package's `models/layers.py:187-361` in its plain form:
nearest-upsample + concat + conv, not the TPU's phase-packed convolutions
(the two are equal, tests/test_models.py:203).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (Flax) semantics.

    Train mode normalizes with the biased batch variance, as torch does, but
    also tracks the running variance with the biased batch variance, where
    torch would use the unbiased one; momentum 0.1 here is Flax's 0.9.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def conv_bn_relu(in_ch: int, out_ch: int, kernel: int = 1, dilation: int = 1) -> nn.Sequential:
    """Conv (no bias) + BN + ReLU; keys `0.weight`, `1.*`."""
    pad = ((kernel - 1) // 2) * dilation
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, kernel, padding=pad, dilation=dilation, bias=False),
        BatchNorm2d(out_ch), nn.ReLU(inplace=True))


class Conv3x3(nn.Module):
    """Reflection pad + 3x3 conv (reference monodepth_layers.py:127-142)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv = nn.Conv2d(in_ch, out_ch, 3)

    def forward(self, x):
        return self.conv(self.pad(x))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (reference monodepth_layers.py:108-124); keys
    `block.0.conv.*`, and `block.1` is the reference's BatchNorm slot, an
    Identity in every configuration the port runs."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = nn.Sequential(Conv3x3(in_ch, out_ch), nn.Identity(), nn.ELU(inplace=True))

    def forward(self, x):
        return self.block(x)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (reference models/model_parts.py:5-32,
    torchvision deeplabv3 layout): 1x1 branch, dilated 3x3 branches and a
    global-pool branch -> 1x1 projection + BN + ReLU + dropout(0.5)."""

    def __init__(self, in_ch: int, atrous_rates: Sequence[int], out_ch: int = 256):
        super().__init__()
        convs = [conv_bn_relu(in_ch, out_ch, 1)]
        convs += [conv_bn_relu(in_ch, out_ch, 3, dilation=r) for r in atrous_rates]
        convs.append(nn.Sequential(nn.AdaptiveAvgPool2d(1), *conv_bn_relu(in_ch, out_ch, 1)))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(*conv_bn_relu(len(convs) * out_ch, out_ch, 1),
                                     nn.Dropout(0.5))

    def forward(self, x):
        branches = [conv(x) for conv in self.convs]
        # the pooled 1x1 map, bilinearly upsampled, is a broadcast
        branches[-1] = branches[-1].expand(-1, -1, *x.shape[2:])
        return self.project(torch.cat(branches, dim=1))


class SelfAttention(nn.Module):
    """Conv-gated local attention, conv3x3(x) * sigmoid(gate3x3(x)), both
    bias-free with zero padding; the gate starts at zero (reference
    models/model_parts.py:35-46, JAX models/layers.py:363-376)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.attention = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)

    def forward(self, x):
        return self.conv(x) * torch.sigmoid(self.attention(x))


def init_weights(module: nn.Module) -> None:
    """The JAX package's initialisation: every conv kernel from a truncated
    normal with variance 2 / fan_out (Flax variance_scaling(2.0, "fan_out",
    "truncated_normal")), conv biases zero, BN scale 1 and bias 0, and the
    SelfAttention gates zero."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            # std of a unit normal truncated to [-2, 2]
            std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for m in module.modules():
        if isinstance(m, SelfAttention):
            nn.init.zeros_(m.attention.weight)
