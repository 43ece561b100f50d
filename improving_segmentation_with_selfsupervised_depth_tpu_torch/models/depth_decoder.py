"""Monodepth U-Net decoder (NCHW), in the reference `decoder.{i}` layout.

Port of the JAX package's `models/depth_decoder.py` for the configurations
the repository's configs use: stages i = n_upconv..0, each upconv_i_0
(ConvBlock, with BatchNorm under `batch_norm` as in dec9, or ASPP at the
bottleneck when `intermediate_aspp`), a nearest x2
upsample only when the skip is spatially larger (a dilated encoder gives
stages 4 and 3 one stride), concat with the skip, upconv_i_1; sigmoid
`dispconv` heads at `scales` unless `enable_disparity` is off. The ModuleList
order is the reference's (depth_decoder.py:43-72): per stage upconv_i_0, an
Identity slot for the skip projection (stages > 0), upconv_i_1; then one
dispconv per scale.

Partial execution (the PAD decoder splices attention between two halves,
JAX depth_decoder.py:57-64): `exec_layer` lists the stages to run, and `x`
replaces the bottleneck as the input of the first of them.

Outputs: "upconv_{i}" per executed stage and "disp_{s}" (N, 1, H/2^s, W/2^s),
always f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.resize import upsample2x_nearest
from .layers import ASPP, Conv3x3, ConvBlock


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int] = (0, 1, 2, 3),
                 intermediate_aspp: bool = False, aspp_rates: Sequence[int] = (6, 12, 18),
                 num_ch_dec: Sequence[int] = (16, 32, 64, 128, 256), n_upconv: int = 4,
                 enable_disparity: bool = True, batch_norm: bool = False):
        super().__init__()
        self.scales = tuple(scales)
        self.n_upconv = n_upconv
        self.index = {}  # ("upconv", i, j) | ("dispconv", s) -> position in `decoder`
        mods = []

        def add(key, module):
            self.index[key] = len(mods)
            mods.append(module)

        for i in range(n_upconv, -1, -1):
            in_ch = num_ch_enc[-1] if i == n_upconv else num_ch_dec[i + 1]
            if i == n_upconv and intermediate_aspp:
                add(("upconv", i, 0), ASPP(in_ch, aspp_rates, num_ch_dec[i]))
            else:
                add(("upconv", i, 0), ConvBlock(in_ch, num_ch_dec[i], batch_norm))
            in_ch = num_ch_dec[i]
            if i > 0:
                mods.append(nn.Identity())  # the reference's skip-projection slot
                in_ch += num_ch_enc[i - 1]
            add(("upconv", i, 1), ConvBlock(in_ch, num_ch_dec[i], batch_norm))
        self.enable_disparity = enable_disparity
        for s in self.scales if enable_disparity else ():
            add(("dispconv", s), Conv3x3(num_ch_dec[s], 1))
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
            if i > 0:
                x = torch.cat([x, input_features[i - 1]], dim=1)
            x = self._m("upconv", i, 1)(x)
            outputs[f"upconv_{i}"] = x
            if i in self.scales and self.enable_disparity:
                # the sigmoid in f32 under autocast, as JAX's
                outputs[f"disp_{i}"] = torch.sigmoid(self._m("dispconv", i)(x).float())
        return outputs
