"""Segmentation metrics: the confusion matrix and the IoU family.

Port of the JAX package's `ops/metrics.py` (reference
evaluation/metrics.py:7-99). The (C, C) confusion matrix is counted on the
tensors' device in int64 (one `bincount` per batch), so it is exact at any
count; only the matrix goes to the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def confusion_matrix(label_true: torch.Tensor, label_pred: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """Integer labels of any shape -> (C, C) int64 counts; rows are the truth,
    columns the prediction. Pixels whose true label lies outside [0, C) are
    ignored; predictions are clipped to [0, C - 1]."""
    lt = label_true.reshape(-1).long()
    lp = label_pred.reshape(-1).long().clamp(0, num_classes - 1)
    valid = (lt >= 0) & (lt < num_classes)
    # invalid pixels count in an extra bin, which is dropped
    cell = torch.where(valid, lt * num_classes + lp, num_classes * num_classes)
    counts = torch.bincount(cell, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def scores_from_confusion(hist) -> Tuple[Dict[str, float], Dict[int, float]]:
    """Overall and mean accuracy, frequency-weighted accuracy, mean IoU and the
    per-class IoU of a (C, C) matrix (classes without support are left out
    of the means)."""
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        mean_iu = np.nanmean(iu)
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return ({"Overall Acc: \t": float(acc), "Mean Acc : \t": float(acc_cls),
             "FreqW Acc : \t": float(fwavacc), "Mean IoU : \t": float(mean_iu)},
            dict(zip(range(hist.shape[0]), iu)))


class RunningScore:
    """The reference `runningScore`: a confusion matrix summed on the host."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def update(self, label_trues, label_preds):
        self.update_matrix(confusion_matrix(torch.as_tensor(label_trues),
                                            torch.as_tensor(label_preds), self.n_classes))

    def update_matrix(self, mat):
        if isinstance(mat, torch.Tensor):
            mat = mat.cpu().numpy()
        self.mat = self.mat + np.asarray(mat, dtype=np.float64)

    def get_scores(self):
        return scores_from_confusion(self.mat)

    def reset(self):
        self.mat = np.zeros((self.n_classes, self.n_classes), dtype=np.float64)


class AverageMeter:
    """Reference evaluation/metrics.py:58-76."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += self.val * n
        self.count += n
        self.avg = self.sum / self.count


class AverageMeterDict:
    """Reference evaluation/metrics.py:79-99: an average per key."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avgs: Dict[str, float] = {}
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def update(self, vals, n=1):
        for k, v in vals.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * n
            self.counts[k] = self.counts.get(k, 0) + n
            self.avgs[k] = self.sums[k] / self.counts[k]
