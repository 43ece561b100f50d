"""Label-selection driver: the iterative annotate-train loop (exp-211).

Port of the JAX package's `label_selection/driver.py` (reference
label_selection.py:26-337). Each round builds a new run (`build_run`, model
and optimizer from the seed) from a deep copy of the mutated config, in its
own log subdirectory; scoring runs the student and the SDE depth teacher at
batch 1 in eval mode without gradient, on the device the caller names.
"""

from __future__ import annotations

import json
import os
import time
from copy import deepcopy
from datetime import datetime
from typing import Any, Dict, List

import numpy as np
import torch
import yaml

from ..config.machine import expand_cfg_vars, machine_paths
from ..engine.checkpoints import apply_pretraining
from ..engine.depth_estimator import decoder_variant
from ..engine.trainer import Run, build_run, train_main
from ..models.joint import build_model
from ..ops.losses import pixel_wise_entropy
from ..ops.photometric import key_of
from ..utils.misc import np_local_seed
from .scoring import (
    calc_feature_distance,
    extract_depth_features,
    iterative_farthest_point,
    masked_depth_error,
)


def get_n_total(cfg) -> int:
    """The train split's size (reference label_selection.py:651-659; the
    synthetic dataset's `n_samples`). Cityscapes, CamVid and Mapillary are
    the published splits' sizes, whatever the tree on disk holds."""
    dataset = cfg["data"]["dataset"]
    if dataset == "synthetic":
        return cfg["data"].get("n_samples", 16)
    return {"cityscapes": 2975, "camvid": 367, "mapillary": 18000}[dataset]


def _build_run(cfg, experiment_name: str, device: str) -> Run:
    """A round's run, in its own log subdirectory (reference build_trainer,
    148-173)."""
    cfg = deepcopy(cfg)
    run_id = experiment_name + "_" + datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    log_dir = os.path.join(cfg["training"]["log_path"], experiment_name)
    os.makedirs(log_dir, exist_ok=True)
    cfg["training"]["log_path"] = log_dir
    with open(os.path.join(log_dir, "cfg.yml"), "w") as fp:
        yaml.safe_dump(cfg, fp)
    return build_run(cfg, device, run_id)


def build_depth_teacher(cfg):
    """The frozen SDE depth model of the diversity features (reference
    317-337), on the CPU with its random init; its weights come from
    `apply_pretraining`. Returns (model, cfg)."""
    cfg = deepcopy(cfg)
    cfg["model"]["arch"] = "joint_segmentation_depth"
    cfg["model"].update(cfg.get("monodepth_options", {}))
    cfg["model"]["segmentation_name"] = None
    cfg["model"]["disable_monodepth"] = False
    cfg["model"]["disable_pose"] = True
    if cfg["data"].get("depth_teacher") is not None:
        cfg["model"]["backbone_name"] = "resnet101"
        cfg, _ = decoder_variant(cfg, 6, (512, 512))
        cfg["model"]["depth_pretraining"] = cfg["data"]["depth_teacher"]
        cfg["model"]["backbone_pretraining"] = cfg["data"]["depth_teacher"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg["model"], cfg["data"].get("n_classes", 19))
    return model, cfg


def _host_image(t: torch.Tensor) -> np.ndarray:
    return t.permute(1, 2, 0).float().cpu().numpy()


@torch.no_grad()
def acquire_scores(base_cfg, samples_to_score, all_samples, model_file,
                   depth_ifp_w: float = 0, verbose: bool = False, device: str = "cuda:0"):
    """Score candidate samples (reference acquire_scores, 347-571): each
    sample of `samples_to_score` through the student loaded from
    `model_file` (depth errors, entropy), and with `depth_ifp_w` every sample
    of `all_samples` through the depth teacher (diversity features).

    Returns (scores, feature distances dict); the dict's `seconds` holds the
    host time per sample of the loader, the teacher's features and the
    student's scoring (each waits for its results), and the distance
    matrix's."""
    calc_depth_distances = depth_ifp_w > 0
    ls = base_cfg["label_selection"]
    depth_lambda = ls["depth_lambda"]
    entropy_lambda = ls["entropy_lambda"]
    dist_bias_weight = ls["bias_weight"]
    ifp_args = ls["ifp_args"]
    error_types = ls.get("depth_error_types", "abs")
    if not isinstance(error_types, list):
        error_types = [error_types]

    cfg = deepcopy(base_cfg)
    cfg["data"]["augmentations"] = {}
    cfg.get("monodepth_options", {}).pop("crop_h", None)
    cfg.get("monodepth_options", {}).pop("crop_w", None)
    cfg["data"].pop("crop_h", None)
    cfg["data"].pop("crop_w", None)
    cfg["training"]["batch_size"] = 1
    cfg["training"]["val_batch_size"] = 1
    restrict = all_samples if calc_depth_distances else samples_to_score
    cfg["data"]["restrict_to_subset"] = {
        "mode": "fixed", "n_subset": len(restrict), "subset": list(restrict)}
    cfg["training"]["resume"] = None  # model-only load below
    cfg["training"]["unlabeled_segmentation"] = None

    run = _build_run(cfg, "label_selection_scoring", device)
    loader = run.train_loader_sequential()
    scores: List[Dict[str, Any]] = []
    all_depth_features: List[torch.Tensor] = []
    dist_i_to_img_idx: Dict[int, int] = {}
    img_idx_to_dist_i: Dict[int, int] = {}
    dist_bias: List[float] = []
    seconds: Dict[str, Any] = {"load": [], "teacher": [], "score": []}
    try:
        if model_file is not None:
            run.load_resume(model_file, load_model_only=True)
        model = run.model.eval()
        samples_set = set(int(s) for s in samples_to_score)
        teacher = None
        if calc_depth_distances and ifp_args.get("m") in ("aspp", "u4", "u3", "bn"):
            teacher, teacher_cfg = build_depth_teacher(cfg)
            apply_pretraining(teacher, teacher_cfg["model"],
                              machine_paths()["DOWNLOAD_MODEL_DIR"])
            teacher = teacher.to(device).eval()

        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            b = run.to_device(batch)
            idx = int(np.asarray(batch["idx"])[0])
            seconds["load"].append(time.perf_counter() - t0)

            if calc_depth_distances:
                t0 = time.perf_counter()
                t_out = teacher(b) if teacher is not None else {}
                feats = extract_depth_features(t_out, b.get("pseudo_depth"), ifp_args)
                dist_i_to_img_idx[len(all_depth_features)] = idx
                img_idx_to_dist_i[idx] = len(all_depth_features)
                all_depth_features.append(feats[0].cpu())
                seconds["teacher"].append(time.perf_counter() - t0)
                if not verbose and dist_bias_weight == 0:
                    scores.append({"idx": idx, "label_criterion": [0],
                                   "depth_error": [0], "entropy_mean": 0})
                    continue

            if idx not in samples_set:
                dist_bias.append(0.0)
                continue

            t0 = time.perf_counter()
            outputs = model(b)
            entropy_mean, entropy_map = 0.0, None
            if "semantics" in outputs:
                entropy_map = pixel_wise_entropy(outputs["semantics"].float())[0]
                entropy_mean = float(entropy_map.mean())
            disp_pred = outputs["disp_0"][0, 0].float()
            disp_pseudo = b["pseudo_depth"][0, 0]
            maps, errs = zip(*(masked_depth_error(disp_pred, disp_pseudo, et)
                               for et in error_types))
            depth_errors = [float(e) for e in torch.stack(errs).cpu()]

            if isinstance(depth_lambda, list):
                label_criterion = [dl * depth_errors[0] + el * entropy_mean
                                   for dl, el in zip(depth_lambda, entropy_lambda)]
            elif len(error_types) > 1:
                label_criterion = [depth_lambda * de + entropy_lambda * entropy_mean
                                   for de in depth_errors]
            else:
                label_criterion = [depth_lambda * depth_errors[0]
                                   + entropy_lambda * entropy_mean]
            if dist_bias_weight > 0:
                if len(label_criterion) != 1:
                    raise ValueError("a distance bias needs exactly one label criterion")
                dist_bias.append(dist_bias_weight * label_criterion[0])

            rec = {"idx": idx, "label_criterion": label_criterion,
                   "depth_error": depth_errors, "entropy_mean": entropy_mean}
            if verbose:
                rec.update({
                    "image": _host_image(b[key_of("color_aug", 0, 0)][0]),
                    "segmentation_entropy": (0 if entropy_map is None
                                             else entropy_map.cpu().numpy()),
                    "disparity": np.log(np.clip(1 / disp_pred.cpu().numpy(), 0.1, 80)),
                    "teacher_depth": np.log(np.clip(1 / disp_pseudo.cpu().numpy(), 0.1, 80)),
                    "depth_error_map": torch.stack(maps).cpu().numpy(),
                    "segmentation_gt": np.asarray(batch.get("lbl", [0]))[0],
                })
            scores.append(rec)
            seconds["score"].append(time.perf_counter() - t0)
    finally:
        loader.close()
        run.close()

    feature_distances = 0
    t0 = time.perf_counter()
    if calc_depth_distances:
        feats = torch.stack(all_depth_features).to(device)
        bias = np.asarray(dist_bias, np.float32) if dist_bias_weight > 0 else None
        feature_distances = depth_ifp_w * calc_feature_distance(
            feats, bias, dist_bias_weight, p=ifp_args.get("p", 2),
            normalize_features=ifp_args.get("norm", False),
            patch_wise=ifp_args.get("pw", False))
    return scores, {"distances": feature_distances,
                    "dist_i_to_img_idx": dist_i_to_img_idx,
                    "img_idx_to_dist_i": img_idx_to_dist_i,
                    "seconds": dict(seconds, distances=time.perf_counter() - t0)}


def choose_samples_from_scores(scores, n_to_add):
    """Top-k by the combined score, round-robin over the criteria when
    there are several (reference 196-221)."""
    if len(scores[0]["label_criterion"]) > 1:
        n_criteria = len(scores[0]["label_criterion"])
        n_per = n_to_add // n_criteria
        if n_criteria * n_per != n_to_add:
            raise ValueError(f"{n_to_add} samples do not split over {n_criteria} criteria")
        chosen, chosen_scores = [], []
        for i in range(n_criteria):
            for s in sorted(scores, key=lambda k: k["label_criterion"][i], reverse=True):
                if s["idx"] not in chosen:
                    s = dict(s)
                    s["used_label_criterion"] = f"C{i}_{s['label_criterion'][i]:.4f}"
                    chosen.append(s["idx"])
                    chosen_scores.append(s)
                if len(chosen) >= (i + 1) * n_per:
                    break
        return chosen, chosen_scores
    ranked = sorted(scores, key=lambda k: k["label_criterion"][0], reverse=True)
    chosen_scores = [dict(s) for s in ranked[:n_to_add]]
    for s in chosen_scores:
        s["used_label_criterion"] = f"{s['label_criterion'][0]:.4f}"
    return [s["idx"] for s in chosen_scores], chosen_scores


def choose_samples_from_ifp(initial_samples, scores, feature_distances, n_to_add,
                            preselection_multiplier):
    """IFP, optionally among the top-scoring samples (reference 224-252)."""
    if len(scores[0]["label_criterion"]) != 1:
        raise ValueError("IFP takes exactly one label criterion")
    preselected = None
    if preselection_multiplier is not None:
        if preselection_multiplier <= 0:
            raise ValueError(f"preselection_multiplier {preselection_multiplier}")
        ranked = sorted(scores, key=lambda k: k["label_criterion"][0], reverse=True)
        preselected = [s["idx"] for s in ranked[: int(preselection_multiplier * n_to_add)]]
    idxs, dists = iterative_farthest_point(initial_samples, feature_distances,
                                           n_to_add, preselected)
    chosen, chosen_scores = [], []
    by_idx = {s["idx"]: s for s in scores}
    for i, dist in zip(idxs, dists):
        if preselected is not None and i not in preselected:
            raise AssertionError(f"IFP chose {i} outside the preselection")
        s = dict(by_idx[i])
        s.update({"label_criterion": dist, "used_label_criterion": f"{dist:.4f}",
                  "iterative_farthest_distance": dist})
        chosen.append(i)
        chosen_scores.append(s)
    if len(chosen_scores) != n_to_add:
        raise AssertionError(f"IFP chose {len(chosen_scores)} samples of {n_to_add}")
    return chosen, chosen_scores


def choose_initial_samples(cfg, n, mode, device: str = "cuda:0"):
    """The first round's samples (reference 176-193): a seeded permutation's
    first `n`, or IFP from its first."""
    if mode == "random":
        with np_local_seed(cfg["seed"]):
            p = np.random.permutation(get_n_total(cfg))
        return p[:n].tolist()
    if mode == "ifp":
        with np_local_seed(cfg["seed"]):
            p = np.random.permutation(get_n_total(cfg))
        seed_sample = p[:1].tolist()
        ifp_cfg = deepcopy(cfg)
        ifp_cfg["label_selection"].update({"preselection_multiplier": None, "bias_weight": 0})
        return choose_new_samples(ifp_cfg, None, seed_sample, n, "ifp", debug=False,
                                  device=device)
    raise NotImplementedError(mode)


def choose_new_samples(cfg, model_file, current_samples, n_new_subset, choice,
                       debug: bool = False, device: str = "cuda:0"):
    """The next round's subset: `current_samples` and the chosen ones
    (reference 255-314)."""
    n_to_add = n_new_subset - len(current_samples)
    if n_to_add <= 0:
        raise ValueError(f"{n_new_subset} samples asked, {len(current_samples)} chosen")
    n_all = cfg["label_selection"].get("n_random_choice_all", get_n_total(cfg))
    preselection_multiplier = cfg["label_selection"]["preselection_multiplier"]
    with np_local_seed(cfg["seed"]):
        all_samples = np.random.permutation(np.arange(get_n_total(cfg)))[:n_all].tolist()
    unlabeled = [v for v in all_samples if v not in current_samples]

    if choice == "ifp":
        scores, feat_dists = acquire_scores(
            cfg, unlabeled, all_samples, model_file,
            depth_ifp_w=cfg["label_selection"]["depth_ifp_weight"], device=device)
        if preselection_multiplier is not None and sum(
                v for k, v in cfg["label_selection"].items() if "lambda" in k) == 0:
            raise ValueError("a preselection needs a nonzero lambda")
        chosen, _ = choose_samples_from_ifp(current_samples, scores, feat_dists,
                                            n_to_add, preselection_multiplier)
    elif choice == "score":
        lambdas = sum(v for k, v in cfg["label_selection"].items()
                      if "lambda" in k and not isinstance(v, list))
        if not isinstance(cfg["label_selection"]["entropy_lambda"], list) and lambdas == 0:
            chosen = unlabeled[:n_to_add]
        else:
            scores, _ = acquire_scores(cfg, unlabeled, all_samples, model_file, device=device)
            chosen, _ = choose_samples_from_scores(scores, n_to_add)
    else:
        raise NotImplementedError(choice)

    new_subset = list(current_samples) + list(chosen)
    if len(new_subset) != n_new_subset or len(set(new_subset)) != len(new_subset):
        raise AssertionError(f"subset {new_subset}: {n_new_subset} distinct samples asked")
    if debug:
        _dump_debug_panels(cfg, chosen, all_samples, model_file, n_new_subset, device)
    return new_subset


def _dump_debug_panels(cfg, chosen, all_samples, model_file, n_new_subset, device):
    """2x3 matplotlib panels of the newly chosen samples (reference
    288-312); nothing where matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except Exception:
        return
    logs, _ = acquire_scores(cfg, chosen, all_samples, model_file, verbose=True, device=device)
    log_dir = os.path.join(cfg["training"]["log_path"], f"new_labels_{n_new_subset}")
    os.makedirs(log_dir, exist_ok=True)
    from ..data.cityscapes import decode_segmap_tocolor

    for i, log in enumerate(logs):
        fig, axs = plt.subplots(2, 3, figsize=(12, 6))
        axs[0][0].imshow(log["image"])
        axs[0][1].imshow(log["disparity"], cmap="plasma_r")
        axs[0][2].imshow(log["teacher_depth"], cmap="plasma_r")
        axs[1][0].imshow(log["depth_error_map"][0], cmap="plasma")
        if np.ndim(log.get("segmentation_entropy", 0)):
            axs[1][1].imshow(log["segmentation_entropy"], cmap="viridis")
        if np.ndim(log.get("segmentation_gt", 0)):
            axs[1][2].imshow(decode_segmap_tocolor(log["segmentation_gt"]))
        for ax in axs.flat:
            ax.axis("off")
        plt.savefig(os.path.join(log_dir, f"new_label_{i}.jpg"))
        plt.close(fig)


def train_on_subset(base_cfg, labeled_samples, train_iters, model_file=None,
                    device: str = "cuda:0") -> str:
    """Train a new run on a fixed subset (resuming `model_file` where
    given), save its state and return the path of `best_model` (reference
    119-142)."""
    base_log_dir = base_cfg["training"]["log_path"]
    cfg = deepcopy(base_cfg)
    cfg["data"]["restrict_to_subset"] = {
        "mode": "fixed", "n_subset": len(labeled_samples),
        "subset": [int(s) for s in labeled_samples]}
    cfg["training"]["train_iters"] = int(train_iters)
    if cfg["training"].get("lr_schedule") and "max_iter" in cfg["training"]["lr_schedule"]:
        cfg["training"]["lr_schedule"]["max_iter"] = int(train_iters)
    if model_file is not None:
        cfg["training"]["resume"] = model_file
    cfg["training"]["save_model"] = True

    experiment_name = f"nlabels{len(labeled_samples)}"
    with open(os.path.join(base_log_dir, f"{experiment_name}_subset.json"), "w") as fp:
        json.dump([int(s) for s in labeled_samples], fp)
    run = _build_run(cfg, experiment_name, device)
    try:
        train_main(run.cfg, device, run=run)
        path = run.save_resume()[0]
        run.checkpoints.wait_for_saves()
    finally:
        run.close()
    return path


def label_selection_main(cfg: Dict[str, Any], device: str = "cuda:0") -> None:
    """The annotate-train loop (reference label_selection_main, 26-116):
    per round, choose the subset (IFP, scores or at random), then train on
    it (from scratch or continuing the last round's model) and keep only
    the newest model file."""
    run_id = datetime.now().strftime("%Y-%m-%d_%H-%M-%S-%f")
    cfg.setdefault("name", "test" + run_id)
    expand_cfg_vars(cfg)
    cfg["training"]["log_path"] = os.path.join(cfg["training"]["log_path"], cfg["name"])
    log_dir = cfg["training"]["log_path"]
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "cfg.yml"), "w") as fp:
        yaml.safe_dump(cfg, fp)

    ls = cfg["label_selection"]
    remove_models = ls.get("remove_models", True)
    train_from_scratch = ls["train_from_scratch"]
    last_from_scratch = ls.get("last_from_scratch", train_from_scratch)
    label_steps = list(ls["label_steps"])
    iters_per_step = [int(v) for v in ls["train_iters"]]
    tasks = ls["selection_tasks"]
    choice = ls["choice"]
    initial = ls["initial_samples"]
    if choice not in ("score", "ifp", "random") or initial not in ("random", "ifp") \
            or tasks not in ("depth", "seg", "seg+depth"):
        raise ValueError(f"label_selection: choice {choice}, initial_samples {initial}, "
                         f"selection_tasks {tasks}")

    if train_from_scratch:
        iters_until_step = iters_per_step
    else:
        iters_until_step = [sum(iters_per_step[: i + 1]) for i in range(len(iters_per_step))]
    if choice in ("ifp", "random"):
        if not (last_from_scratch or train_from_scratch):
            raise ValueError(f"choice {choice} trains the last round from scratch")
        if sum(v for k, v in ls.items() if "lambda" in k) == 0:
            label_steps = [label_steps[-1]]
            iters_until_step = [iters_until_step[-1]]

    resume_step, resume_file = ls.get("resume", (-1, ""))
    if len(label_steps) != len(iters_until_step):
        raise ValueError(f"label_steps {label_steps}, train_iters {iters_until_step}")

    model_file = None
    labeled_samples: List[int] = []
    if resume_file:
        model_file = resume_file
        with open(f"{os.path.dirname(resume_file)}_subset.json") as fp:
            labeled_samples = json.load(fp)

    for i, (n_new_subset, train_iters) in enumerate(zip(label_steps, iters_until_step)):
        is_last = i == len(label_steps) - 1
        if i < resume_step:
            continue
        if i == 0:
            labeled_samples = choose_initial_samples(cfg, n_new_subset, mode=initial,
                                                     device=device)
        else:
            labeled_samples = choose_new_samples(cfg, model_file, labeled_samples,
                                                 n_new_subset, choice, device=device)
        if train_iters == 0:
            continue
        current = deepcopy(cfg)
        old_model_file = model_file
        model_to_continue = old_model_file
        if not is_last:
            current["training"]["val_interval"] = {"0": 4000}
        if train_from_scratch or (is_last and last_from_scratch):
            model_to_continue = None
        if tasks == "depth" and not is_last:
            current["training"]["segmentation_lambda"] = 0
        if tasks == "seg" and not is_last:
            current["training"]["pseudo_depth_lambda"] = 0
            current["training"]["monodepth_lambda"] = 0
        if is_last and ls.get("last_segmentation_only", False):
            current["training"]["pseudo_depth_lambda"] = 0
            current["training"]["monodepth_lambda"] = 0
        if is_last and ls.get("last_depth_only", False):
            current["training"]["segmentation_lambda"] = 0
        model_file = train_on_subset(current, labeled_samples, train_iters,
                                     model_to_continue, device=device)
        if remove_models and old_model_file and old_model_file != resume_file:
            os.remove(old_model_file)
    if remove_models and model_file and model_file != resume_file:
        os.remove(model_file)
