"""JAX parameter trees -> the port's state_dict (reference checkpoint layout).

`state_dict_from_jax(params, batch_stats, model_cfg)` is the inverse of the
JAX package's `engine/full_model_interop.py::convert_full_model`: it takes the
Flax `params`/`batch_stats` trees (as numpy arrays) and returns the state_dict
that `models.joint.JointSegmentationDepth.load_state_dict` takes. Conv
kernels go from (kH, kW, I, O) to (O, I, kH, kW); BatchNorm scale/bias/mean/
var to weight/bias/running_mean/running_var (a decoder ConvBlock's
`BatchNorm_0`, dec9's `batch_norm`, to `block.1`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_DISP_SCALES = (0, 1, 2, 3)  # the reference decoder's dispconv slots


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(sd, key, kernel):
    sd[key] = _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _bn(sd, prefix, p, s):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])
    sd[prefix + ".running_mean"] = _t(s["mean"])
    sd[prefix + ".running_var"] = _t(s["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0)


def _resnet(sd, prefix, p, s):
    _conv(sd, prefix + "conv1.weight", p["conv1"]["kernel"])
    _bn(sd, prefix + "bn1", p["bn1"], s["bn1"])
    bottleneck = "conv3" in p["layer1_0"]
    sizes = (len([k for k in p if k.startswith(f"layer{i}_")]) for i in range(1, 5))
    for stage, n_blocks in enumerate(sizes, start=1):
        for b in range(n_blocks):
            bp, bs = p[f"layer{stage}_{b}"], s[f"layer{stage}_{b}"]
            tpre = f"{prefix}layer{stage}.{b}."
            n_convs = 3 if bottleneck else 2
            for k in range(1, n_convs + 1):
                _conv(sd, tpre + f"conv{k}.weight", bp[f"conv{k}"]["kernel"])
                _bn(sd, tpre + f"bn{k}", bp[f"BatchNorm_{k - 1}"], bs[f"BatchNorm_{k - 1}"])
            if "ds_conv" in bp:
                _conv(sd, tpre + "downsample.0.weight", bp["ds_conv"]["kernel"])
                _bn(sd, tpre + "downsample.1", bp[f"BatchNorm_{n_convs}"],
                    bs[f"BatchNorm_{n_convs}"])


def _conv_bn_relu(sd, prefix, p, s):
    _conv(sd, prefix + ".0.weight", p["Conv_0"]["kernel"])
    _bn(sd, prefix + ".1", p["BatchNorm_0"], s["BatchNorm_0"])


def _depth_decoder(sd, prefix, p, s, depth_args):
    # positions in the reference ModuleList: per stage upconv_i_0, the skip
    # slot (stages > 0, no parameters), upconv_i_1; then the dispconv slots
    n_upconv = depth_args.get("n_upconv", 4)
    order = []
    for i in range(n_upconv, -1, -1):
        order += [f"upconv_{i}_0"] + (["skip"] if i > 0 else []) + [f"upconv_{i}_1"]
    order += [f"dispconv_{sc}" for sc in _DISP_SCALES]
    for pos, name in enumerate(order):
        tpre = f"{prefix}decoder.{pos}."
        if name not in p:
            continue  # skip slot or absent disparity head
        mp = p[name]
        if name.startswith("dispconv"):
            _conv(sd, tpre + "conv.weight", mp["Conv_0"]["kernel"])
            sd[tpre + "conv.bias"] = _t(mp["Conv_0"]["bias"])
        elif "ConvBNReLU_0" in mp:  # ASPP: branches, pooled branch last, projection
            ms = s[name]
            n_conv = sum(k.startswith("ConvBNReLU_") for k in mp) - 1
            for k in range(n_conv - 1):
                _conv_bn_relu(sd, tpre + f"convs.{k}", mp[f"ConvBNReLU_{k}"],
                              ms[f"ConvBNReLU_{k}"])
            pooled = f"ConvBNReLU_{n_conv - 1}"  # [pool, conv, bn, relu]
            _conv(sd, tpre + f"convs.{n_conv - 1}.1.weight", mp[pooled]["Conv_0"]["kernel"])
            _bn(sd, tpre + f"convs.{n_conv - 1}.2", mp[pooled]["BatchNorm_0"],
                ms[pooled]["BatchNorm_0"])
            _conv_bn_relu(sd, tpre + "project", mp[f"ConvBNReLU_{n_conv}"],
                          ms[f"ConvBNReLU_{n_conv}"])
        else:  # ConvBlock: Conv3x3, then BatchNorm (dec9's batch_norm) in slot 1
            _conv(sd, tpre + "block.0.conv.weight", mp["Conv3x3_0"]["Conv_0"]["kernel"])
            sd[tpre + "block.0.conv.bias"] = _t(mp["Conv3x3_0"]["Conv_0"]["bias"])
            if "BatchNorm_0" in mp:
                _bn(sd, tpre + "block.1", mp["BatchNorm_0"], s[name]["BatchNorm_0"])


def _seg_decoder(sd, prefix, p, s, depth_args):
    _depth_decoder(sd, prefix + "unet_dec.", p["unet_dec"], s.get("unet_dec", {}), depth_args)
    for name in p:
        if name.startswith("project_seg"):
            _conv(sd, f"{prefix}project.seg{name[len('project_seg'):]}.0.weight",
                  p[name]["kernel"])
    cls = 1
    if "head_conv" in p:
        _conv(sd, prefix + "head.1.weight", p["head_conv"]["kernel"])
        _bn(sd, prefix + "head.2", p["head_bn"], s["head_bn"])
        cls = 5
    _conv(sd, f"{prefix}head.{cls}.weight", p["classifier"]["kernel"])
    sd[f"{prefix}head.{cls}.bias"] = _t(p["classifier"]["bias"])


def _pad(sd, prefix, p, s, depth_args):
    # JAX full_model_interop.py::_convert_pad, inverted
    for branch in ("depth_dec", "seg_dec"):
        _depth_decoder(sd, f"{prefix}{branch}.", p[branch], s.get(branch, {}), depth_args)
    for sa in ("sa_depth", "sa_seg"):
        _conv(sd, f"{prefix}{sa}.conv.weight", p[sa]["Conv_0"]["kernel"])
        _conv(sd, f"{prefix}{sa}.attention.weight", p[sa]["Conv_1"]["kernel"])
    for head in ("seg_final_head", "seg_intermediate_head"):
        if head in p:
            _conv(sd, f"{prefix}{head}.0.weight", p[head]["kernel"])
            sd[f"{prefix}{head}.0.bias"] = _t(p[head]["bias"])


def state_dict_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        model_cfg: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax (params, batch_stats) of the joint model -> the port's state_dict."""
    unknown = set(params) - {"encoder", "pose_encoder", "pose", "depth", "segmentation",
                             "mtl_decoder", "imnet_encoder"}
    if unknown:
        raise ValueError(f"unknown JAX submodules {sorted(unknown)}")
    depth_args = dict(model_cfg.get("depth_args") or {})
    sd: Dict[str, torch.Tensor] = {}
    for enc in ("encoder", "pose_encoder", "imnet_encoder"):
        if enc in params:
            _resnet(sd, f"models.{enc}.encoder.", params[enc], batch_stats[enc])
    if "pose" in params:
        for i, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
            _conv(sd, f"models.pose.net.{i}.weight", params["pose"][name]["kernel"])
            sd[f"models.pose.net.{i}.bias"] = _t(params["pose"][name]["bias"])
    if "depth" in params:
        _depth_decoder(sd, "models.depth.", params["depth"], batch_stats.get("depth", {}),
                       depth_args)
    if "segmentation" in params:
        _seg_decoder(sd, "models.segmentation.", params["segmentation"],
                     batch_stats.get("segmentation", {}), depth_args)
    if "mtl_decoder" in params:
        _pad(sd, "models.mtl_decoder.", params["mtl_decoder"],
             batch_stats.get("mtl_decoder", {}), depth_args)
    return sd
