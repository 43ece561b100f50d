"""The single-process case of the port's `parallel/dist.py`: every
collective is the identity, every batch mean the plain mean."""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def world() -> int:
    return 1


def rank() -> int:
    return 0


def is_main() -> bool:
    return True


def rank_rows(x: torch.Tensor) -> torch.Tensor:
    return x


def rank_draw(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    return draw(tuple(shape))


def global_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def global_max(x: torch.Tensor) -> torch.Tensor:
    return x.detach()


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum()


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def gather_ranks(x: torch.Tensor) -> torch.Tensor:
    return x[None]


def roll_next(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, shifts=-1, dims=0)
