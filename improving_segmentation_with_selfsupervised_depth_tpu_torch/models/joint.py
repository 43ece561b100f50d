"""Joint segmentation + self-supervised-depth model (NCHW).

Port of the JAX package's `models/joint.py` (reference
models/joint_segmentation_depth.py:10-183). The submodules live in the
`models` ModuleDict under the reference's names, so the state_dict keys are
the reference checkpoint's (engine/full_model_interop.py:10-21):

  models.encoder        ResNetEncoder backbone
  models.depth          DepthDecoder (monodepth on, not mtl_pad)
  models.segmentation   JointSegDepthDecoder
  models.mtl_decoder    PAD (segmentation_name: mtl_pad)
  models.pose_encoder   ResNetEncoder(depth 18, num_input_images=2, or the
                        number of non-stereo frames with
                        `pose_model_input: all`)
  models.pose           PoseDecoder
  models.imnet_encoder  the frozen ImageNet ResNet of the feature-distance
                        loss (`enable_imnet_encoder`)

Forward takes the batch dict (see ops/photometric.py) and returns "bottleneck",
"disp_{s}", "semantics" (N, classes, H, W), with PAD "intermediate_semantics",
with the ImageNet encoder "encoder_features" (the backbone's last feature)
and "imnet_features" (the ImageNet encoder's, without gradient), and, unless
`use_pose=False`, "axisangle_0_{f}", "translation_0_{f}" (N, 2, 1, 3) and
"cam_T_cam_0_{f}" (N, 4, 4) for each non-stereo source frame f (a stereo
frame "s" warps with the batch's `stereo_T`; frames (0, "s") have no pose
network). The pose network reads `color_aug_{f}_0`, or the uncropped
`color_full_aug_{f}_0` with `provide_uncropped_for_pose`. With `remat` the
encoder and the ImageNet encoder checkpoint each residual block
(`models/resnet.py`). Train or eval mode is the module's own
(`model.train()` / `model.eval()`); with `freeze_backbone_bn` the encoder
stays in eval mode, so its BatchNorm normalizes with its running statistics
and leaves them unchanged (the JAX `train_encoder_bn=False`). The ImageNet
encoder is always in eval mode.

With `amp` (the JAX model's `dtype=bfloat16`, `training.amp`) the networks
run under `torch.autocast(..., torch.bfloat16)`: convolutions in bf16 on f32
parameters, BatchNorm statistics in f32 (`layers.BatchNorm2d`). The
disparities and the poses come out in f32, as JAX's do, and the pose
geometry (`cam_T_cam`) runs outside autocast, in f32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from ..ops.geometry import transformation_from_parameters
from ..ops.photometric import key_of
from .depth_decoder import DepthDecoder
from .layers import init_weights, seed_dropout
from .pose_decoder import PoseDecoder
from .resnet import ResNetEncoder, num_ch_enc
from .seg_decoder import PAD, JointSegDepthDecoder

_BACKBONE_DEPTH = {"resnet18": 18, "resnet34": 34, "resnet50": 50, "resnet101": 101,
                   "resnet152": 152}


class JointSegmentationDepth(nn.Module):
    def __init__(self, backbone_depth: int = 101, replace_stride_with_dilation=None,
                 segmentation_name="joint_seg_depth_dec", segmentation_args=None,
                 depth_args=None, num_classes: int = 19, frame_ids=(0, -1, 1),
                 num_scales: int = 4, pose_model_input: str = "pairs",
                 pose_pair_batching: bool = True, provide_uncropped_for_pose: bool = False,
                 disable_monodepth: bool = False, disable_pose: bool = False,
                 freeze_backbone_bn: bool = False, enable_imnet_encoder: bool = False,
                 imnet_encoder_dilation: bool = True, remat: bool = False, amp: bool = False):
        super().__init__()
        if frame_ids[0] != 0:
            raise ValueError(f"frame_ids must start with 0: {frame_ids}")
        self.frame_ids = tuple(frame_ids)
        # the frames the pose network reads, stereo left out
        self.pose_frames = tuple(f for f in self.frame_ids if f != "s")
        self.pose_model_input = pose_model_input
        self.pose_pair_batching = pose_pair_batching
        self.pose_source = "color_full_aug" if provide_uncropped_for_pose else "color_aug"
        self.freeze_backbone_bn = freeze_backbone_bn
        self.amp = amp
        self.use_pose_net = (not disable_pose and not disable_monodepth and len(frame_ids) > 1
                             and self.frame_ids != (0, "s"))
        ch_enc = num_ch_enc(backbone_depth)
        depth_args = dict(depth_args or {})
        models = {"encoder": ResNetEncoder(
            backbone_depth, replace_stride_with_dilation=replace_stride_with_dilation,
            remat=remat)}
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
            n_pose = 2 if pose_model_input == "pairs" else len(self.pose_frames)
            models["pose_encoder"] = ResNetEncoder(18, num_input_images=n_pose)
            models["pose"] = PoseDecoder(num_ch_enc(18), 1, 2)
        if enable_imnet_encoder:
            models["imnet_encoder"] = ResNetEncoder(
                backbone_depth, replace_stride_with_dilation=(
                    replace_stride_with_dilation if imnet_encoder_dilation else None),
                remat=remat)
        self.models = nn.ModuleDict(models)
        init_weights(self)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_backbone_bn:
            self.models["encoder"].train(False)
        if "imnet_encoder" in self.models:
            self.models["imnet_encoder"].train(False)
        return self

    def _autocast(self, x: torch.Tensor):
        """bf16 autocast on `x`'s device under `amp`, else a no-op."""
        return torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=self.amp)

    def predict_poses(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Poses of the non-stereo source frames (reference
        joint_segmentation_depth.py:20-70). With `pose_model_input: pairs`,
        pairwise in temporal order, inverted for past frames; with
        `pose_pair_batching` the pairs share one pose-encoder forward, so its
        train-mode BatchNorm sees all pairs at once, as in the JAX package.
        Otherwise one forward of all frames stacked on the channels, frame i
        of `frame_ids[1:]` taking the decoder's pose i, not inverted."""
        feats = {f: inputs[key_of(self.pose_source, f, 0)] for f in self.pose_frames}
        encoder, pose = self.models["pose_encoder"], self.models["pose"]
        if self.pose_model_input != "pairs":
            with self._autocast(feats[0]):
                axisangle, translation = pose([encoder(torch.cat(list(feats.values()), 1))])
            outputs = {}
            for i, f in enumerate(self.frame_ids[1:]):
                if f == "s":
                    continue
                outputs[key_of("axisangle", 0, f)] = axisangle
                outputs[key_of("translation", 0, f)] = translation
                outputs[key_of("cam_T_cam", 0, f)] = transformation_from_parameters(
                    axisangle[:, i], translation[:, i])
            return outputs
        outputs = {}
        pair_frames = list(self.pose_frames[1:])
        pair_inputs = {f: torch.cat([feats[f], feats[0]] if f < 0 else [feats[0], feats[f]],
                                    dim=1) for f in pair_frames}
        with self._autocast(feats[0]):
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
        image = inputs[key_of("color_aug", 0, 0)]
        with self._autocast(image):
            features = self.models["encoder"](image)
            outputs = {"bottleneck": features[-1]}
            if "mtl_decoder" in self.models:
                outputs.update(self.models["mtl_decoder"](features))
            if "depth" in self.models:
                outputs.update(self.models["depth"](features))
            if "segmentation" in self.models:
                outputs["semantics"] = self.models["segmentation"](features)
            if "imnet_encoder" in self.models:
                outputs["encoder_features"] = features[-1]
                with torch.no_grad():
                    outputs["imnet_features"] = self.models["imnet_encoder"](image)[-1]
        if self.use_pose_net and use_pose:
            outputs.update(self.predict_poses(inputs))
        return outputs

    def predict_test_disp(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The pose-free depth forward on the un-augmented `color_0_0`
        (reference joint_segmentation_depth.py:72-75): the depth decoder's
        outputs, or all of PAD's."""
        image = inputs[key_of("color", 0, 0)]
        with self._autocast(image):
            features = self.models["encoder"](image)
            if "mtl_decoder" in self.models:
                return self.models["mtl_decoder"](features)
            return self.models["depth"](features)


def build_model(model_cfg: Dict[str, Any], n_classes: int,
                amp: bool = False, seed: int = 0) -> JointSegmentationDepth:
    """Config-dict factory with the JAX package's `build_model` schema;
    `amp` is the JAX `dtype=bfloat16` (`training.amp`); `seed` is the run's,
    from which each depth-decoder dropout takes its own stream."""
    m = dict(model_cfg)
    rsd = m.get("replace_stride_with_dilation")
    depth_args = dict(m.get("depth_args") or {})
    depth_args.pop("max_scale_size", None)  # static shapes make it redundant
    seg_args = dict(m.get("segmentation_args") or {})
    seg_args.pop("weights", None)  # pretrained weights are a checkpoint concern
    model = JointSegmentationDepth(
        backbone_depth=_BACKBONE_DEPTH[m.get("backbone_name", "resnet101")],
        replace_stride_with_dilation=tuple(rsd) if rsd else None,
        segmentation_name=m.get("segmentation_name"),
        segmentation_args=seg_args,
        depth_args=depth_args,
        num_classes=n_classes,
        frame_ids=tuple(m.get("frame_ids", (0, -1, 1))),
        num_scales=m.get("num_scales", 4),
        pose_model_input=m.get("pose_model_input", "pairs"),
        pose_pair_batching=m.get("pose_pair_batching", True),
        provide_uncropped_for_pose=m.get("provide_uncropped_for_pose", False),
        disable_monodepth=m.get("disable_monodepth", False),
        disable_pose=m.get("disable_pose", False),
        freeze_backbone_bn=m.get("freeze_backbone_bn", False),
        enable_imnet_encoder=m.get("enable_imnet_encoder", False),
        imnet_encoder_dilation=m.get("imnet_encoder_dilation", True),
        remat=m.get("remat", False),
        amp=amp,
    )
    seed_dropout(model, seed)
    return model
