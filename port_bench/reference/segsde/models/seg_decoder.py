"""Segmentation decoders on SDE features (NCHW), reference layout.

Port of the JAX package's `models/seg_decoder.py`.

`JointSegDepthDecoder` (JAX :62-157, reference
joint_segmentation_depth_decoder.py:11-75):
a full DepthDecoder U-Net (`unet_dec`), 1x1 projections of the chosen pyramid
layers (`project.seg{L}`; layers 0-4 are encoder features, 5-9 decoder stage
outputs upconv_{9-L}), bilinear resize to full // output_stride, concat, the
head `head.{j}` = [dropout | identity, conv3x3, BN, ReLU, dropout, 1x1
classifier], and a resize of the logits to full resolution. The JAX
package's fused single-layer path composes project + head conv into one conv;
this is the plain form of the same math.

`PAD` (JAX :158-237, reference joint_segmentation_depth_decoder.py:78-184),
the multi-task decoder: a depth and a segmentation DepthDecoder, both run up
to the distillation layer; each branch's features there pass through a
zero-gated SelfAttention into the other branch; both finish; 1x1 heads give
the final logits and, as a side output, logits at the distillation layer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear
from .depth_decoder import DepthDecoder
from .layers import BatchNorm2d, Dropout, SelfAttention

_DEFAULT_NUM_CH_DEC = (16, 32, 64, 128, 256)


def _get_layer(encoder_features, decoder_outputs, layer: int):
    if layer <= 4:
        return encoder_features[layer]
    return decoder_outputs[f"upconv_{9 - layer}"]


class JointSegDepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], num_classes: int,
                 layers: Sequence[int] = (9,), head_inter_channels: int = 64,
                 head_dropout: float = 0.1, layer_dropout: float = 0.0,
                 output_stride: int = 1, layer_out_channels: int = 64,
                 head_inter: bool = True, depth_args: Optional[Dict[str, Any]] = None):
        super().__init__()
        depth_args = dict(depth_args or {})
        num_ch_dec = tuple(depth_args.get("num_ch_dec", _DEFAULT_NUM_CH_DEC))
        self.layers = tuple(layers)
        self.output_stride = output_stride
        self.unet_dec = DepthDecoder(num_ch_enc, **depth_args)
        self.project = nn.ModuleDict({
            f"seg{layer}": nn.Sequential(nn.Conv2d(
                num_ch_enc[layer] if layer <= 4 else num_ch_dec[9 - layer],
                layer_out_channels, 1, bias=False))
            for layer in self.layers})
        cat_ch = layer_out_channels * len(self.layers)
        head = [Dropout(layer_dropout) if layer_dropout > 0 else nn.Identity()]
        if head_inter:
            head += [nn.Conv2d(cat_ch, head_inter_channels, 3, padding=1, bias=False),
                     BatchNorm2d(head_inter_channels), nn.ReLU(inplace=True),
                     Dropout(head_dropout)]
            cat_ch = head_inter_channels
        head.append(nn.Conv2d(cat_ch, num_classes, 1))
        self.head = nn.Sequential(*head)

    def forward(self, encoder_features):
        seg_features = self.unet_dec(encoder_features)
        seg_size = _get_layer(encoder_features, seg_features, 9).shape[2:]
        last_size = (seg_size[0] // self.output_stride, seg_size[1] // self.output_stride)
        x = torch.cat([
            resize_bilinear(self.project[f"seg{layer}"](
                _get_layer(encoder_features, seg_features, layer)), last_size)
            for layer in self.layers], dim=1)
        score = self.head(x)
        return resize_bilinear(score, seg_size).float()


class PAD(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], num_classes: int, final_layer: int = 9,
                 output_stride: int = 1, distillation_layer: int = 7, side_output: bool = True,
                 depth_args: Optional[Dict[str, Any]] = None):
        super().__init__()
        depth_args = dict(depth_args or {})
        num_ch_dec = tuple(depth_args.get("num_ch_dec", _DEFAULT_NUM_CH_DEC))
        n_upconv = depth_args.get("n_upconv", 4)
        self.final_layer = final_layer
        self.output_stride = output_stride
        self.side_output = side_output
        dec_distill_i = 9 - distillation_layer
        self.inter_key = f"upconv_{dec_distill_i}"
        self.first_half = tuple(range(n_upconv, dec_distill_i - 1, -1))
        self.second_half = tuple(range(dec_distill_i - 1, -1, -1))

        def layer_channels(layer: int) -> int:
            return num_ch_enc[layer] if layer <= 4 else num_ch_dec[9 - layer]

        self.depth_dec = DepthDecoder(num_ch_enc, scales=(0, 1, 2, 3), **depth_args)
        self.seg_dec = DepthDecoder(num_ch_enc, scales=(0, 1, 2, 3), enable_disparity=False,
                                    **depth_args)
        distill_ch = layer_channels(distillation_layer)
        self.sa_depth = SelfAttention(distill_ch, distill_ch)
        self.sa_seg = SelfAttention(distill_ch, distill_ch)
        self.seg_final_head = nn.Sequential(
            nn.Conv2d(layer_channels(final_layer), num_classes, 1))
        if side_output:
            self.seg_intermediate_head = nn.Sequential(nn.Conv2d(distill_ch, num_classes, 1))

    def forward(self, encoder_features) -> Dict[str, torch.Tensor]:
        depth_features = self.depth_dec(encoder_features, exec_layer=self.first_half)
        seg_features = self.seg_dec(encoder_features, exec_layer=self.first_half)
        depth_inter = depth_features[self.inter_key]
        seg_inter = seg_features[self.inter_key]
        intermediate_seg = None
        if self.side_output:
            intermediate_seg = self.seg_intermediate_head(seg_inter).float()
        merged_for_seg = seg_inter + self.sa_depth(depth_inter)
        merged_for_depth = depth_inter + self.sa_seg(seg_inter)
        depth_features.update(self.depth_dec(encoder_features, x=merged_for_depth,
                                             exec_layer=self.second_half))
        seg_features = self.seg_dec(encoder_features, x=merged_for_seg,
                                    exec_layer=self.second_half)
        final_seg = self.seg_final_head(
            _get_layer(None, seg_features, self.final_layer)).float()

        # the JAX package takes the reference size from encoder feature 0
        seg_size = tuple(encoder_features[0].shape[2:])
        last_size = (seg_size[0] // self.output_stride, seg_size[1] // self.output_stride)
        if last_size != seg_size:
            final_seg = resize_bilinear(final_seg, seg_size)
            if self.side_output:
                intermediate_seg = resize_bilinear(intermediate_seg, seg_size)
        out = dict(depth_features)
        out["semantics"] = final_seg
        if self.side_output:
            out["intermediate_semantics"] = intermediate_seg
        return out
