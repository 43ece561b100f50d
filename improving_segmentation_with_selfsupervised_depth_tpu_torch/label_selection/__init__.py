"""Automatic label selection for annotation (reference label_selection.py),
the port of the JAX package's `label_selection/`: an iterative
annotate-train loop driven by SDE uncertainty (the depth error against the
pseudo-depth teacher, the segmentation entropy) and diversity (iterative
farthest point over pooled depth features)."""

from .driver import (
    acquire_scores,
    choose_initial_samples,
    choose_new_samples,
    get_n_total,
    label_selection_main,
    train_on_subset,
)
from .scoring import calc_feature_distance, iterative_farthest_point

__all__ = [
    "label_selection_main",
    "train_on_subset",
    "choose_initial_samples",
    "choose_new_samples",
    "get_n_total",
    "acquire_scores",
    "calc_feature_distance",
    "iterative_farthest_point",
]
