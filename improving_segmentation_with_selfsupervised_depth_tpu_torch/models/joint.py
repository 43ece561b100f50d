"""Joint segmentation + self-supervised-depth model (NCHW).

Port of the JAX package's `models/joint.py` (reference
models/joint_segmentation_depth.py:10-183). The submodules live in the
`models` ModuleDict under the reference's names, so the state_dict keys are
the reference checkpoint's (engine/full_model_interop.py:10-21):

  models.encoder        ResNetEncoder backbone
  models.depth          DepthDecoder (monodepth on, not mtl_pad)
  models.segmentation   JointSegDepthDecoder
  models.mtl_decoder    PAD (segmentation_name: mtl_pad)
  models.pose_encoder   ResNetEncoder(depth 18, num_input_images=2)
  models.pose           PoseDecoder

Forward takes the batch dict (see ops/photometric.py) and returns "bottleneck",
"disp_{s}", "semantics" (N, classes, H, W), with PAD "intermediate_semantics",
and, unless `use_pose=False`, "axisangle_0_{f}", "translation_0_{f}"
(N, 2, 1, 3) and "cam_T_cam_0_{f}" (N, 4, 4). Train or eval mode is the
module's own (`model.train()` / `model.eval()`); with `freeze_backbone_bn`
the encoder stays in eval mode, so its BatchNorm normalizes with its running
statistics and leaves them unchanged (the JAX `train_encoder_bn=False`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .. import not_ported
from ..ops.geometry import transformation_from_parameters
from ..ops.photometric import key_of
from .depth_decoder import DepthDecoder
from .layers import init_weights
from .pose_decoder import PoseDecoder
from .resnet import ResNetEncoder, num_ch_enc
from .seg_decoder import PAD, JointSegDepthDecoder

_BACKBONE_DEPTH = {"resnet18": 18, "resnet34": 34, "resnet50": 50, "resnet101": 101,
                   "resnet152": 152}


class JointSegmentationDepth(nn.Module):
    def __init__(self, backbone_depth: int = 101, replace_stride_with_dilation=None,
                 segmentation_name="joint_seg_depth_dec", segmentation_args=None,
                 depth_args=None, num_classes: int = 19, frame_ids=(0, -1, 1),
                 num_scales: int = 4, pose_pair_batching: bool = True,
                 disable_monodepth: bool = False, disable_pose: bool = False,
                 freeze_backbone_bn: bool = False):
        super().__init__()
        if frame_ids[0] != 0 or "s" in frame_ids:
            raise ValueError(f"frame_ids must start with 0 and hold no stereo 's': {frame_ids}")
        self.frame_ids = tuple(frame_ids)
        self.pose_pair_batching = pose_pair_batching
        self.freeze_backbone_bn = freeze_backbone_bn
        self.use_pose_net = not disable_pose and not disable_monodepth and len(frame_ids) > 1
        ch_enc = num_ch_enc(backbone_depth)
        depth_args = dict(depth_args or {})
        models = {"encoder": ResNetEncoder(
            backbone_depth, replace_stride_with_dilation=replace_stride_with_dilation)}
        seg_args = dict(segmentation_args or {})
        if segmentation_name == "mtl_pad":
            models["mtl_decoder"] = PAD(ch_enc, num_classes, depth_args=depth_args, **seg_args)
        else:
            if not disable_monodepth:
                models["depth"] = DepthDecoder(ch_enc, scales=tuple(range(num_scales)),
                                               **depth_args)
            if segmentation_name is not None:
                models["segmentation"] = JointSegDepthDecoder(
                    ch_enc, num_classes, depth_args=depth_args, **seg_args)
        if self.use_pose_net:
            models["pose_encoder"] = ResNetEncoder(18, num_input_images=2)
            models["pose"] = PoseDecoder(num_ch_enc(18), 1, 2)
        self.models = nn.ModuleDict(models)
        init_weights(self)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_backbone_bn:
            self.models["encoder"].train(False)
        return self

    def predict_poses(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Pairwise poses in temporal order, inverted for past frames
        (reference joint_segmentation_depth.py:20-70). With
        `pose_pair_batching` the pairs share one pose-encoder forward, so its
        train-mode BatchNorm sees all pairs at once, as in the JAX package."""
        outputs = {}
        feats = {f: inputs[key_of("color_aug", f, 0)] for f in self.frame_ids}
        pair_frames = list(self.frame_ids[1:])
        pair_inputs = {f: torch.cat([feats[f], feats[0]] if f < 0 else [feats[0], feats[f]],
                                    dim=1) for f in pair_frames}
        encoder, pose = self.models["pose_encoder"], self.models["pose"]
        if self.pose_pair_batching and len(pair_frames) > 1:
            n = feats[0].shape[0]
            axisangle, translation = pose([encoder(torch.cat(
                [pair_inputs[f] for f in pair_frames], dim=0))])
            per_pair = {f: (axisangle[i * n:(i + 1) * n], translation[i * n:(i + 1) * n])
                        for i, f in enumerate(pair_frames)}
        else:
            per_pair = {f: pose([encoder(pair_inputs[f])]) for f in pair_frames}
        for f in pair_frames:
            axisangle, translation = per_pair[f]
            outputs[key_of("axisangle", 0, f)] = axisangle
            outputs[key_of("translation", 0, f)] = translation
            outputs[key_of("cam_T_cam", 0, f)] = transformation_from_parameters(
                axisangle[:, 0], translation[:, 0], invert=f < 0)
        return outputs

    def forward(self, inputs: Dict[str, torch.Tensor], use_pose: bool = True
                ) -> Dict[str, torch.Tensor]:
        features = self.models["encoder"](inputs[key_of("color_aug", 0, 0)])
        outputs = {"bottleneck": features[-1]}
        if "mtl_decoder" in self.models:
            outputs.update(self.models["mtl_decoder"](features))
        if "depth" in self.models:
            outputs.update(self.models["depth"](features))
        if "segmentation" in self.models:
            outputs["semantics"] = self.models["segmentation"](features)
        if self.use_pose_net and use_pose:
            outputs.update(self.predict_poses(inputs))
        return outputs

    def predict_test_disp(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The pose-free depth forward on the un-augmented `color_0_0`
        (reference joint_segmentation_depth.py:72-75): the depth decoder's
        outputs, or all of PAD's."""
        features = self.models["encoder"](inputs[key_of("color", 0, 0)])
        if "mtl_decoder" in self.models:
            return self.models["mtl_decoder"](features)
        return self.models["depth"](features)


def build_model(model_cfg: Dict[str, Any], n_classes: int) -> JointSegmentationDepth:
    """Config-dict factory with the JAX package's `build_model` schema."""
    m = dict(model_cfg)
    if m.get("enable_imnet_encoder", False):
        raise not_ported("model.enable_imnet_encoder (feature-distance loss)",
                         "SDE pretraining, phase 2")
    if m.get("pose_model_input", "pairs") != "pairs":
        raise not_ported("model.pose_model_input other than 'pairs'", "exp-210 options")
    if m.get("provide_uncropped_for_pose", False):
        raise not_ported("model.provide_uncropped_for_pose", "exp-210 options")
    if m.get("remat", False):
        raise not_ported("model.remat", "amp/bf16 model")
    rsd = m.get("replace_stride_with_dilation")
    depth_args = dict(m.get("depth_args") or {})
    depth_args.pop("max_scale_size", None)  # static shapes make it redundant
    seg_args = dict(m.get("segmentation_args") or {})
    seg_args.pop("weights", None)  # pretrained weights are a checkpoint concern
    return JointSegmentationDepth(
        backbone_depth=_BACKBONE_DEPTH[m.get("backbone_name", "resnet101")],
        replace_stride_with_dilation=tuple(rsd) if rsd else None,
        segmentation_name=m.get("segmentation_name"),
        segmentation_args=seg_args,
        depth_args=depth_args,
        num_classes=n_classes,
        frame_ids=tuple(m.get("frame_ids", (0, -1, 1))),
        num_scales=m.get("num_scales", 4),
        pose_pair_batching=m.get("pose_pair_batching", True),
        disable_monodepth=m.get("disable_monodepth", False),
        disable_pose=m.get("disable_pose", False),
        freeze_backbone_bn=m.get("freeze_backbone_bn", False),
    )
