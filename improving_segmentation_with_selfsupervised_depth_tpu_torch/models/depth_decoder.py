"""Monodepth U-Net decoder (NCHW), in the reference `decoder.{i}` layout.

Port of the JAX package's `models/depth_decoder.py`: stages
i = n_upconv..0, each upconv_i_0 (ConvBlock, with BatchNorm under
`batch_norm` as in dec9, or ASPP at the bottleneck when `intermediate_aspp`,
without its pooled branch when `aspp_pooling` is off), a nearest x2 upsample
only when the skip is spatially larger (a dilated encoder gives stages 4 and
3 one stride), concat with the skip (unless `use_skips` is off; projected by
a 1x1 conv + BN + ReLU to `n_project_skip_ch` channels when that is not -1),
upconv_i_1; every ConvBlock ends in channel-wise `dropout` when it is > 0;
sigmoid `dispconv` heads of `num_output_channels` at `scales` unless
`enable_disparity` is off. The ModuleList order is the reference's
(depth_decoder.py:43-72): per stage upconv_i_0, the skip projection's slot
(stages > 0; an Identity without projection), upconv_i_1; then one dispconv
per scale.

Partial execution (the PAD decoder splices attention between two halves,
JAX depth_decoder.py:57-64): `exec_layer` lists the stages to run, and `x`
replaces the bottleneck as the input of the first of them.

Outputs: "upconv_{i}" per executed stage and "disp_{s}"
(N, num_output_channels, H/2^s, W/2^s), always f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.resize import upsample2x_nearest
from .layers import ASPP, Conv3x3, ConvBlock, conv_bn_relu


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int] = (0, 1, 2, 3),
                 intermediate_aspp: bool = False, aspp_rates: Sequence[int] = (6, 12, 18),
                 num_ch_dec: Sequence[int] = (16, 32, 64, 128, 256), n_upconv: int = 4,
                 enable_disparity: bool = True, batch_norm: bool = False,
                 num_output_channels: int = 1, use_skips: bool = True, dropout: float = 0.0,
                 n_project_skip_ch: int = -1, aspp_pooling: bool = True):
        super().__init__()
        self.scales = tuple(scales)
        self.n_upconv = n_upconv
        self.use_skips = use_skips
        self.index = {}  # ("upconv", i, j) | ("dispconv", s) -> position in `decoder`
        mods = []

        def add(key, module):
            self.index[key] = len(mods)
            mods.append(module)

        for i in range(n_upconv, -1, -1):
            in_ch = num_ch_enc[-1] if i == n_upconv else num_ch_dec[i + 1]
            if i == n_upconv and intermediate_aspp:
                add(("upconv", i, 0), ASPP(in_ch, aspp_rates, num_ch_dec[i], aspp_pooling))
            else:
                add(("upconv", i, 0), ConvBlock(in_ch, num_ch_dec[i], batch_norm, dropout))
            in_ch = num_ch_dec[i]
            if i > 0:
                # the reference's skip-projection slot
                if use_skips and n_project_skip_ch != -1:
                    add(("skip_proj", i), conv_bn_relu(num_ch_enc[i - 1], n_project_skip_ch))
                    in_ch += n_project_skip_ch
                else:
                    mods.append(nn.Identity())
                    in_ch += num_ch_enc[i - 1] if use_skips else 0
            add(("upconv", i, 1), ConvBlock(in_ch, num_ch_dec[i], batch_norm, dropout))
        self.enable_disparity = enable_disparity
        for s in self.scales if enable_disparity else ():
            add(("dispconv", s), Conv3x3(num_ch_dec[s], num_output_channels))
        self.decoder = nn.ModuleList(mods)

    def _m(self, *key) -> nn.Module:
        return self.decoder[self.index[key]]

    def forward(self, input_features, x: Optional[torch.Tensor] = None,
                exec_layer: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
        outputs = {}
        if x is None:
            x = input_features[-1]
        layers = range(self.n_upconv, -1, -1) if exec_layer is None else exec_layer
        for i in range(self.n_upconv, -1, -1):
            if i not in layers:
                continue
            x = self._m("upconv", i, 0)(x)
            if i == 0 or x.shape[3] < input_features[i - 1].shape[3]:
                x = upsample2x_nearest(x)
            if i > 0 and self.use_skips:
                skip = input_features[i - 1]
                if ("skip_proj", i) in self.index:
                    skip = self._m("skip_proj", i)(skip)
                x = torch.cat([x, skip], dim=1)
            x = self._m("upconv", i, 1)(x)
            outputs[f"upconv_{i}"] = x
            if i in self.scales and self.enable_disparity:
                # the sigmoid in f32 under autocast, as JAX's
                outputs[f"disp_{i}"] = torch.sigmoid(self._m("dispconv", i)(x).float())
        return outputs
