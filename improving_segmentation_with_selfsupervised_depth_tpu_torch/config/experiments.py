"""Experiment-config generation: the port's copy of the JAX package's
`config/experiments.py` (reference experiments.py).

`generate_experiment_cfgs(base_cfg, id)` derives the config set for the three
published experiment families:

  210  semi-supervised segmentation with SDE transfer (+ ClassMix/DepthMix,
       mean teacher, preselected subsets)            reference experiments.py:138-223
  211  automatic label selection (entropy + depth-error scoring, IFP)
                                                     reference experiments.py:225-314
  212  semi-supervised multi-task PAD decoder        reference experiments.py:316-405

For the same base config it gives the JAX package's configs, key for key.
Tags are plain strings expanded by `config/grid.py::expand_grid`.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List

from ..data.preselected import preselected_labels
from ..engine.depth_estimator import decoder_variant
from .grid import grid_search


def setup_optimizer(cfg, opt, lr, blr, plr, slr, gclip):
    """reference experiments.py:32-48."""
    o = {"name": opt, "lr": lr, "backbone_lr": blr}
    if plr is not None:
        o["pose_lr"] = plr
    if slr is not None:
        o["segmentation_lr"] = slr
    if opt == "sgd":
        o.update({"momentum": 0.9, "weight_decay": 0.0005})
    cfg["training"]["optimizer"] = o
    cfg["training"]["clip_grad_norm"] = gclip
    return cfg


def lr_schedule(cfg, lr_sch, max_iter, step=30e3):
    """reference experiments.py:51-75."""
    schedules = {
        "step": {"name": "step_lr", "step_size": int(50e3), "gamma": 0.1},
        "step2": {"name": "multi_step", "milestones": [int(30e3), int(40e3), int(50e3)],
                  "gamma": 0.5},
        "step30": {"name": "step_lr", "step_size": int(30e3), "gamma": 0.1},
        "stepx": {"name": "step_lr", "step_size": int(step), "gamma": 0.1},
        "poly": {"name": "poly_lr_2", "power": 0.9, "max_iter": max_iter},
    }
    cfg["training"]["lr_schedule"] = schedules[lr_sch]
    return cfg


_DATASET_PRESETS = {
    # train_iters, lr step, final val interval, (w, h), path var, val split
    "cityscapes": (int(40e3), int(30e3), 500, (1024, 512), "MachineConfig.CITYSCAPES_DIR", "val"),
    "mapillary": (int(40e3), int(30e3), 1000, (704, 512), "MachineConfig.MAPILLARY_DIR", "validation"),
    "camvid": (int(20e3), int(15e3), 500, (672, 512), "MachineConfig.CAMVID_DIR", "test"),
}


def setup_dataset(cfg, dataset, crop, lr_sch):
    """reference experiments.py:77-97."""
    train_iters, step, final_vi, (w, h), path, val_split = _DATASET_PRESETS[dataset]
    cfg["data"].update({"dataset": dataset, "path": path, "val_split": val_split})
    cfg["monodepth_options"].update(
        {"height": h, "width": w, "crop_h": crop[0], "crop_w": crop[1]})
    cfg["training"]["train_iters"] = train_iters
    cfg = lr_schedule(cfg, lr_sch, train_iters, step=step)
    cfg["training"]["val_interval"][str(int(step))] = final_vi
    return cfg


def set_segmentation_args(cfg, seg_init, layers, head_inter, output_stride,
                          head_dropout=0.1):
    """reference experiments.py:99-110."""
    cfg["model"]["segmentation_args"] = {
        "weights": seg_init,
        "layers": layers,
        "head_inter_channels": 64,
        "layer_out_channels": 64,
        "head_dropout": head_dropout,
        "layer_dropout": 0,
        "head_inter": head_inter,
        "output_stride": output_stride,
    }
    return cfg


def subsets(dataset):
    """Headline label budgets (reference experiments.py:112-133)."""
    return {"cityscapes": [372], "camvid": [100], "mapillary": [2250]}[dataset]


def _sanitize(name: str) -> str:
    return (name.replace(".", "").replace(" ", "").replace(",", "i")
            .replace("(", "I").replace(")", "I"))


def generate_experiment_cfgs(base_cfg: Dict[str, Any], id: int) -> List[Dict[str, Any]]:
    cfgs: List[Dict[str, Any]] = []

    if id == 210:
        layers, output_stride, head_inter = [9], 1, False
        opt, lr, blr, gclip = "sgd", 1e-2, 1e-3, 10
        dataset, lr_sch = "cityscapes", "stepx"
        dec, dec_params, crop, batch_size = 6, "lr5_fd2_crop512x512bs4", (512, 512), 2
        dc_ft, dc_m, pres_method = 0, 0.03, "ds_us"
        for seed in [42]:
            mono_pretrain = f"mono_cityscapes_1024x512_r101dil_aspp_dec{dec}_{dec_params}"
            for n_subset in subsets(dataset):
                # (name, seg_init, teacher_init, ema, mix_mask, only_unlabeled,
                #  mix_use_gt, preselect, mix_video)
                variants = [
                    ("scratch", "none", "none", False, None, True, False, False, False),
                    ("scratch_classmix", "none", "none", True, "class", True, False, False, False),
                    ("transfer", mono_pretrain, mono_pretrain, False, None, True, False, False, False),
                    (f"transfer_dcompgt{dc_m}{dc_ft}", mono_pretrain, mono_pretrain, True,
                     "depthcomp", False, True, False, False),
                    (f"sel_{pres_method}_transfer_dcompgt{dc_m}{dc_ft}", mono_pretrain,
                     mono_pretrain, True, "depthcomp", False, True, True, False),
                ]
                for (name, seg_init, teacher_init, ema, mix_mask, only_unlabeled,
                     mix_use_gt, preselect, mix_video) in variants:
                    name = _sanitize(name)
                    restrict_mode = "fixed" if preselect else "random"
                    unlab_cfg = None
                    unlab_str = ""
                    if ema:
                        unlab_cfg = {
                            "consistency_weight": 1.0,
                            "mix_mask": mix_mask,
                            "color_jitter": True,
                            "blur": True,
                            "only_unlabeled": only_unlabeled,
                            "only_labeled": False,
                            "mix_video": mix_video,
                            "mix_use_gt": mix_use_gt,
                            "depthcomp_margin": dc_m,
                            "depthcomp_foreground_threshold": dc_ft,
                            "backward_first_pseudo_label": False,
                            "debug_image": True,
                        }
                        unlab_str = (f"_Unlab1.0{mix_mask}jitblur")
                    cfg = deepcopy(base_cfg)
                    tag = (f"{dataset}_{name}_D{n_subset}{restrict_mode}_S{seed}_"
                           f"{opt}Lr{lr}{blr}{lr_sch}_clip{gclip}_crop{crop[0]}x{crop[1]}"
                           f"bs{batch_size}_flip_r101_dec{dec}_{dec_params}_l{layers[0]}"
                           f"os{output_stride}{'hi' if head_inter else ''}{unlab_str}")
                    cfg["general"] = {"tag": grid_search([tag])}
                    cfg, load_backbone = decoder_variant(cfg, dec, crop)
                    cfg["model"]["backbone_pretraining"] = (
                        mono_pretrain if (load_backbone and seg_init != "none") else "imnet")
                    cfg["model"]["variant"] = name
                    cfg["model"]["depth_pretraining"] = teacher_init
                    cfg["model"]["depth_estimator_weights"] = mono_pretrain
                    cfg = setup_optimizer(cfg, opt, lr, blr, None, None, gclip)
                    cfg["training"]["batch_size"] = batch_size
                    cfg = setup_dataset(cfg, dataset, crop, lr_sch)
                    cfg["data"]["restrict_to_subset"]["mode"] = restrict_mode
                    cfg["data"]["restrict_to_subset"]["n_subset"] = n_subset
                    if preselect:
                        try:
                            cfg["data"]["restrict_to_subset"]["subset"] = preselected_labels(
                                {7: 42, 25: 43, 42: 44}[seed], n_subset, dataset,
                                method=pres_method)
                        except (FileNotFoundError, KeyError) as e:
                            print(f"Skipping preselected variant {name}: {e}")
                            continue
                    cfg["training"]["unlabeled_segmentation"] = unlab_cfg
                    cfg["seed"] = seed
                    cfg = set_segmentation_args(cfg, seg_init, layers, head_inter,
                                                output_stride)
                    cfgs.append(cfg)

    elif id == 211:
        layers, output_stride, head_inter = [8], 2, True
        opt, lr, blr, plr, slr = "adam", 1e-4, 1e-4, 1e-6, 1e-4
        mono_lambda, psd_lambda, seg_lambda = 0, 1, 1
        depth_loss_log, dataset, lr_sch, gclip = False, "cityscapes", "poly", 100000
        dec, dec_params, crop, batch_size = 9, "", (512, 512), 2
        schedules = {
            "cityscapes": ("labsch_25-50-100-200-372-744_4-8-12-16-20-24-scratch",
                           [25, 50, 100, 200, 372, 744],
                           [4e3, 8e3, 12e3, 16e3, 20e3, 24e3], True, True),
            "camvid": ("labsch_25-50-100_4-8-12-scratch", [25, 50, 100],
                       [4e3, 8e3, 12e3], True, True),
        }
        for seed in [42, 43, 44]:
            mono_pretrain = "mono_cityscapes_1024x512_r101dil_aspp_dec6_lr5_fd2_crop512x512bs2"
            (label_schedule, label_steps, iters_per_step, from_scratch,
             last_from_scratch) = schedules[dataset]
            variants = [
                # (name, depth_lambda, entropy_lambda, dtype, tasks, choice,
                #  depthifp_w, n_pres, bias_w, ifp_args)
                ("depthifp_u3-avg4_bias1000ldepth_donly", 1, 0, "abs_log", "depth",
                 "ifp", 1, None, 1000,
                 {"p": 2, "pool": "avg", "h": 4, "m": "u3", "norm": True}),
            ]
            for (name, depth_lambda, entropy_lambda, dtype_, tasks, choice,
                 depthifp_w, n_pres, bias_w, ifp_args) in variants:
                assert tasks in ("depth", "seg", "seg+depth")
                cfg = deepcopy(base_cfg)
                cfg["main"] = "label_selection"
                cfg["label_selection"] = {
                    "choice": choice,
                    "label_steps": label_steps,
                    "train_iters": iters_per_step,
                    "train_from_scratch": from_scratch,
                    "last_from_scratch": last_from_scratch,
                    "selection_tasks": tasks,
                    "last_segmentation_only": True,
                    "last_depth_only": False,
                    "initial_samples": "ifp" if choice == "ifp" else "random",
                    "preselection_multiplier": n_pres,
                    "depth_ifp_weight": depthifp_w,
                    "bias_weight": bias_w,
                    "ifp_args": ifp_args,
                    "depth_lambda": depth_lambda,
                    "entropy_lambda": entropy_lambda,
                    "depth_error_types": dtype_,
                    "remove_models": True,
                    "resume": ifp_args.get("resume", (-1, "")),
                }
                tag = (f"{dataset}_{name}_{label_schedule}_evseg__S{seed}_"
                       f"{opt}Lr{lr:.1E}{slr:.1E}{blr:.1E}{plr:.1E}{lr_sch}_"
                       f"clip{gclip}_m{mono_lambda}s{seg_lambda}pd{psd_lambda}_"
                       f"dl{depth_loss_log}_crop{crop[0]}x{crop[1]}bs{batch_size}_"
                       f"flip_r101_dec{dec}_{dec_params}_l{layers[0]}os{output_stride}hi")
                cfg["general"] = {"tag": grid_search([tag])}
                cfg["model"]["backbone_name"] = "resnet50"
                cfg, _ = decoder_variant(cfg, dec, crop)
                cfg["model"]["backbone_pretraining"] = "imnet"
                cfg["model"]["variant"] = name
                cfg["model"]["depth_pretraining"] = "none"
                cfg["model"]["pose_pretraining"] = mono_pretrain
                cfg["model"]["disable_pose"] = mono_lambda == 0
                cfg["model"]["disable_monodepth"] = False
                cfg["training"]["segmentation_lambda"] = seg_lambda
                cfg["training"]["monodepth_lambda"] = mono_lambda
                cfg["training"]["pseudo_depth_lambda"] = psd_lambda
                cfg["data"]["depth_teacher"] = mono_pretrain
                cfg = setup_optimizer(cfg, opt, lr, blr, plr, slr, gclip)
                cfg["training"]["pseudo_depth_loss_log"] = depth_loss_log
                cfg["training"]["batch_size"] = batch_size
                cfg = setup_dataset(cfg, dataset, crop, lr_sch)
                cfg["data"]["restrict_to_subset"] = None
                train_iters = (int(cfg["label_selection"]["train_iters"][-1])
                               if from_scratch
                               else int(sum(cfg["label_selection"]["train_iters"])))
                cfg["training"]["train_iters"] = train_iters
                cfg = lr_schedule(cfg, lr_sch, train_iters)
                cfg["seed"] = seed
                cfg = set_segmentation_args(cfg, "none", layers, head_inter,
                                            output_stride, head_dropout=0.0)
                cfgs.append(cfg)

    elif id == 212:
        final_layer, distillation_layer, output_stride, side_output = 9, 7, 1, True
        opt, lr, blr, plr, dlr, gclip = "sgd", 1e-2, 1e-3, 1e-6, 1e-3, 10
        disable_depth_clip, dataset, lr_sch = False, "cityscapes", "stepx"
        backward_first_pseudo_label, mono_lambda, seg_lambda = False, 1, 1
        dec, dec_params, crop, batch_size = 6, "lr5_fd2_crop512x512bs4", (512, 512), 2
        dc_ft, dc_m, pres_method = 0, 0.03, "ds_us"
        for seed in [42]:
            for n_subset in subsets(dataset):
                variants = [
                    (f"pad_transfer_dcompgt{dc_m}{dc_ft}", True, "depthcomp", False, True, False),
                    (f"sel_{pres_method}_pad_transfer_dcompgt{dc_m}{dc_ft}", True,
                     "depthcomp", False, True, True),
                ]
                for name, ema, mix_mask, only_unlabeled, mix_use_gt, preselect in variants:
                    name = _sanitize(name)
                    restrict_mode = "fixed" if preselect else "random"
                    unlab_cfg = {
                        "consistency_weight": 1.0,
                        "mix_mask": mix_mask,
                        "depthmix_online_depth": True,
                        "backward_first_pseudo_label": backward_first_pseudo_label,
                        "color_jitter": True,
                        "blur": True,
                        "only_unlabeled": only_unlabeled,
                        "mix_use_gt": mix_use_gt,
                        "depthcomp_margin": dc_m,
                        "depthcomp_foreground_threshold": dc_ft,
                        "debug_image": True,
                    } if ema else None
                    unlab_str = "" if not ema else (
                        f"_Unlab1.0{mix_mask}FPL{backward_first_pseudo_label}jitblur")
                    mono_pretrain = f"mono_cityscapes_1024x512_r101dil_aspp_dec{dec}_{dec_params}"
                    cfg = deepcopy(base_cfg)
                    tag = (f"{dataset}_{name}_D{n_subset}{restrict_mode}_S{seed}_"
                           f"{opt}Lr{lr:.0E}{blr:.0E}{plr:.0E}{dlr:.0E}{lr_sch}_"
                           f"clip{gclip}{disable_depth_clip}_m{mono_lambda}s{seg_lambda}_"
                           f"crop{crop[0]}x{crop[1]}bs{batch_size}_flip_dec{dec}_"
                           f"{dec_params}_l{final_layer}i{distillation_layer}"
                           f"{side_output}os{output_stride}{unlab_str}")
                    cfg["general"] = {"tag": grid_search([tag])}
                    cfg["model"]["segmentation_name"] = "mtl_pad"
                    cfg["model"]["backbone_name"] = "resnet101"
                    # no encoder remat (`model.remat`), as the JAX generator sets
                    cfg["model"]["remat"] = False
                    cfg, _ = decoder_variant(cfg, dec, crop)
                    cfg["model"]["backbone_pretraining"] = mono_pretrain
                    cfg["model"]["variant"] = name
                    cfg["model"]["depth_estimator_weights"] = mono_pretrain
                    cfg["model"]["depth_pretraining"] = mono_pretrain
                    cfg["model"]["pose_pretraining"] = mono_pretrain
                    cfg["model"]["disable_pose"] = mono_lambda == 0
                    cfg["model"]["disable_monodepth"] = False
                    cfg["training"]["segmentation_lambda"] = seg_lambda
                    cfg["training"]["monodepth_lambda"] = mono_lambda
                    cfg["training"]["disable_depth_estimator"] = True
                    cfg = setup_optimizer(cfg, opt, lr, blr, plr, None, gclip)
                    cfg["training"]["disable_depth_grad_clip"] = disable_depth_clip
                    cfg["training"]["batch_size"] = batch_size
                    cfg = setup_dataset(cfg, dataset, crop, lr_sch)
                    cfg["data"]["restrict_to_subset"]["mode"] = restrict_mode
                    cfg["data"]["restrict_to_subset"]["n_subset"] = n_subset
                    if preselect:
                        try:
                            cfg["data"]["restrict_to_subset"]["subset"] = preselected_labels(
                                {7: 42, 25: 43, 42: 44}[seed], n_subset, dataset,
                                method=pres_method)
                        except (FileNotFoundError, KeyError) as e:
                            print(f"Skipping preselected variant {name}: {e}")
                            continue
                    cfg["training"]["unlabeled_segmentation"] = unlab_cfg
                    cfg["seed"] = seed
                    cfg["model"]["segmentation_args"] = {
                        "weights": mono_pretrain,
                        "output_stride": output_stride,
                        "distillation_layer": distillation_layer,
                        "side_output": side_output,
                        "final_layer": final_layer,
                    }
                    cfgs.append(cfg)
    else:
        raise NotImplementedError(f"Unknown id {id}")

    return cfgs
