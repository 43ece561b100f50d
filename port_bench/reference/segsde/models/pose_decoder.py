"""Pose decoder (NCHW), reference layout `net.{0..3}`.

Port of the JAX package's `models/pose_decoder.py` (reference
models/pose_decoder.py:18-58): shared 1x1 squeeze (-> 256) + ReLU, 3x3, 3x3
and 1x1 convs to 6 * num_frames, spatial mean, x0.01, split into axis-angle
and translation, each (N, num_frames, 1, 3).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class PoseDecoder(nn.Module):
    def __init__(self, num_ch_enc, num_input_features: int = 1,
                 num_frames_to_predict_for: int = 2, stride: int = 1):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1),
            nn.Conv2d(num_input_features * 256, 256, 3, stride, 1),
            nn.Conv2d(256, 256, 3, stride, 1),
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1),
        ])

    def forward(self, input_features):
        out = torch.cat([torch.relu(self.net[0](f[-1])) for f in input_features], dim=1)
        out = torch.relu(self.net[1](out))
        out = torch.relu(self.net[2](out))
        out = self.net[3](out).float().mean((2, 3))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]
