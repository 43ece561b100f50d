"""ResNet feature-pyramid encoder (NCHW), torchvision layout without torchvision.

Port of the JAX package's `models/resnet.py`: returns [f0 (stride 2), f1 (4),
f2, f3, f4] with channels (64, 64, 128, 256, 512), x4 from f1 for depth >= 50;
input normalization (x - 0.45) / 0.225; `replace_stride_with_dilation` with
torchvision semantics; `num_input_images` stacked frames for the pose encoder; with `remat` each
residual block is checkpointed (`torch.utils.checkpoint`), its activations
recomputed in the backward (JAX `nn.remat`, models/resnet.py:116-119), and
its BatchNorm running statistics updated once per forward, not again in the
recompute.
State-dict keys are the reference's: `encoder.conv1.weight`,
`encoder.layer1.0.conv1.weight`, `encoder.layer1.0.downsample.0.weight`, ...
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .layers import BatchNorm2d, frozen_running_stats

STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def num_ch_enc(depth: int) -> Tuple[int, ...]:
    return (64, 256, 512, 1024, 2048) if depth > 34 else (64, 64, 128, 256, 512)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, dilation, dilation, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, dilation, dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNet(nn.Module):
    """torchvision ResNet trunk (no pooling head) returning the 5-level pyramid."""

    def __init__(self, depth: int, in_ch: int = 3,
                 replace_stride_with_dilation: Optional[Sequence[bool]] = None,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        kind, sizes = STAGES[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        dilate = tuple(replace_stride_with_dilation or (False, False, False))
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self._in_ch, self._dilation = 64, 1
        self.layer1 = self._make_layer(block, 64, sizes[0])
        self.layer2 = self._make_layer(block, 128, sizes[1], 2, dilate[0])
        self.layer3 = self._make_layer(block, 256, sizes[2], 2, dilate[1])
        self.layer4 = self._make_layer(block, 512, sizes[3], 2, dilate[2])

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        # torchvision: the stage's first block keeps the dilation from before
        prev_dilation = self._dilation
        if dilate:
            self._dilation *= stride
            stride = 1
        out_ch = planes * block.expansion
        downsample = None
        if stride != 1 or self._in_ch != out_ch:
            downsample = nn.Sequential(nn.Conv2d(self._in_ch, out_ch, 1, stride, bias=False),
                                       BatchNorm2d(out_ch))
        layers = [block(self._in_ch, planes, stride, prev_dilation, downsample)]
        self._in_ch = out_ch
        layers += [block(out_ch, planes, 1, self._dilation) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def _stage(self, layer: nn.Sequential, x):
        if not (self.remat and torch.is_grad_enabled()):
            return layer(x)
        for block in layer:
            x = checkpoint(block, x, use_reentrant=False,
                           context_fn=lambda: (contextlib.nullcontext(),
                                               frozen_running_stats()))
        return x

    def forward(self, x):
        f0 = self.relu(self.bn1(self.conv1(x)))
        f1 = self._stage(self.layer1, self.maxpool(f0))
        f2 = self._stage(self.layer2, f1)
        f3 = self._stage(self.layer3, f2)
        f4 = self._stage(self.layer4, f3)
        return [f0, f1, f2, f3, f4]


class ResNetEncoder(nn.Module):
    """The reference ResnetEncoder: normalization + a ResNet under `encoder`."""

    def __init__(self, depth: int = 101, num_input_images: int = 1,
                 replace_stride_with_dilation: Optional[Sequence[bool]] = None,
                 remat: bool = False):
        super().__init__()
        self.num_ch_enc = num_ch_enc(depth)
        self.encoder = ResNet(depth, 3 * num_input_images, replace_stride_with_dilation,
                              remat)

    def forward(self, x):
        return self.encoder((x - 0.45) / 0.225)
