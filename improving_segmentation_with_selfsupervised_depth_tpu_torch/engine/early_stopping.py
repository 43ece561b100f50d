"""Plateau-based early stopping for the validation-mIoU loop: the port's
copy of the JAX package's `engine/early_stopping.py` (reference
utils/early_stopping.py:3-52, adapted from pytorch-ignite).

An evaluation improves only when its score exceeds the running best by more
than `min_delta`; after `patience` evaluations in a row that do not, training
stops. With `cumulative_delta=False` (default) the running best still tracks
any strictly higher score; with `cumulative_delta=True` it moves only on a
qualifying improvement, so small gains must add up past `min_delta`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class EarlyStopping:
    patience: int
    min_delta: float = 0.0
    cumulative_delta: bool = False
    logger: Optional[object] = None

    best_score: Optional[float] = dataclasses.field(default=None, init=False)
    counter: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        if self.patience < 1:
            raise ValueError("Argument patience should be positive integer.")
        if self.min_delta < 0.0:
            raise ValueError("Argument min_delta should not be a negative number.")

    def step(self, score: float) -> bool:
        """Record one validation score; False means training should stop."""
        prev_best = self.best_score
        improved = prev_best is None or score > prev_best + self.min_delta

        if improved:
            self.best_score = score
            self.counter = 0
            return True

        if not self.cumulative_delta and score > prev_best:
            self.best_score = score
        self.counter += 1
        if self.logger:
            self.logger.info("EarlyStopping: %i / %i", self.counter, self.patience)
        if self.counter >= self.patience:
            if self.logger:
                self.logger.info("EarlyStopping: Stop training")
            return False
        return True
