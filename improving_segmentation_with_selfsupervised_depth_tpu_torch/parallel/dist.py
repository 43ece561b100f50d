"""The process group of data-parallel training and its collectives.

The port's counterpart of the JAX package's `parallel/mesh.py`. JAX jits the
step over a 1-D `data` mesh, state replicated and batch sharded, and GSPMD
makes every batch mean a mean over the global batch. Here each rank is a
process holding a contiguous block of the global batch (`rank_rows`), the
student is wrapped in `DistributedDataParallel`, and every place where the
step reduces over the batch axis says so through these helpers:

- `global_sum` (autograd-aware: its backward all-reduces the incoming
  gradients), `global_max` (no gradient), `batch_sum`, `batch_mean`,
  `batch_count` over the batch axis;
- `roll_next`, the global `roll(x, -1, 0)` of DepthMix's partner sample;
- `rank_draw`, a random draw at the global batch shape from a generator
  seeded alike on every rank, of which the rank keeps its rows;
- `gather_ranks`, every rank's tensor; `gather_rows`, the global batch of
  a tensor, for logging.

Every helper is the identity (or the plain one-process op) at world size 1,
and inside `local_only()`, where rank 0 works alone (the offline
pseudo-depth) while the others wait at a barrier.

The gradient of a global loss. Every rank computes the same global loss L.
An all-reduce's backward sums the ranks' incoming gradients, so each rank's
backward yields the gradient of W * L with respect to its own rows'
computation; DDP then averages the parameter gradients over the W ranks,
which gives the gradient of L. A loss term computed on every rank from
parameters alone (no batch axis) would come out W times too large; the step
has none.

All collectives are all-reduces (and DDP's broadcasts): gloo runs only those
on CUDA tensors, which is how two ranks share one card in `chip_smoke.py`.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

# rank 0 working alone inside `local_only`
_LOCAL = False
# the count of real rows of the global batch (validation's padded batches)
_REAL_ROWS: Optional[int] = None


def world() -> int:
    """The world size: 1 without a process group and inside `local_only`."""
    if _LOCAL or not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def rank() -> int:
    return 0 if world() == 1 else dist.get_rank()


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world() > 1:
        dist.barrier()


@contextlib.contextmanager
def local_only():
    """Rank 0 works alone inside: every helper acts as at world size 1."""
    global _LOCAL
    prev, _LOCAL = _LOCAL, True
    try:
        yield
    finally:
        _LOCAL = prev


@contextlib.contextmanager
def real_rows(n: Optional[int]):
    """Inside, the batch means count only the first `n` rows of the global
    batch (None: all): validation pads a ragged batch to a multiple of the
    world size, and the padded rows then leave the means as they are in one
    process, which does not pad."""
    global _REAL_ROWS
    prev, _REAL_ROWS = _REAL_ROWS, n
    try:
        yield
    finally:
        _REAL_ROWS = prev


def setup(rank_: Optional[int] = None, world_size: Optional[int] = None, *,
          init_method: Optional[str] = None, backend: Optional[str] = None,
          device: Optional[str] = None, timeout_s: float = 1800.0) -> str:
    """Join the process group and return this rank's device.

    Without `rank_` the rank, world size and local rank come from torchrun's
    environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
    `MASTER_PORT`); the launcher passes them with an `init_method`. The
    device is `device` where the caller names one ("cpu", or a card two
    ranks share), else `cuda:{local_rank}`. The backend is NCCL on a CUDA
    device and gloo on the CPU unless `backend` names one."""
    if rank_ is None:
        rank_ = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank_))
        init_method = init_method or "env://"
    else:
        local_rank = rank_
    device = device or f"cuda:{local_rank}"
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.set_device(torch.device(device))
    backend = backend or ("nccl" if is_cuda else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def teardown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of the global batch axis of `x`."""
    w = world()
    if w == 1:
        return x
    if x.shape[0] % w:
        raise ValueError(f"a global batch of {x.shape[0]} rows does not split over {w} ranks")
    k = x.shape[0] // w
    r = rank()
    return x[r * k:(r + 1) * k]


def rank_draw(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """This rank's rows of `draw` at the global batch's shape of a rank's
    `shape`: one process's draw over the whole batch, from a generator in
    the same state on every rank."""
    return rank_rows(draw((shape[0] * world(), *shape[1:])))


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, on every rank. Its backward sums the
    ranks' incoming gradients (see the module docstring)."""
    if world() == 1:
        return x
    return dist_nn.all_reduce(x)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of `x` over the ranks; no gradient."""
    x = x.detach()
    if world() == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def _counted(x: torch.Tensor) -> torch.Tensor:
    """The rows of `x` (this rank's block) that the means count."""
    if _REAL_ROWS is None or world() == 1:
        return x
    k = x.shape[0]
    return x[:max(0, min(k, _REAL_ROWS - rank() * k))]


def global_count(n: int, device) -> torch.Tensor:
    """The sum over the ranks of each rank's count `n`, as a tensor."""
    return global_sum(torch.tensor(float(n), dtype=torch.float64, device=device))


def batch_count(x: torch.Tensor):
    """The count of the global batch's elements of which `x` holds this
    rank's rows: an int, or a tensor where ranks count different rows."""
    if _REAL_ROWS is None or world() == 1:
        return x.numel() * world()
    return global_count(_counted(x).numel(), x.device)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every element of the global batch of `x`."""
    return global_sum(_counted(x).sum())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over every element of the global batch of `x`; `x.mean()`
    in one process."""
    if world() == 1:
        return x.mean()
    s, n = batch_sum(x), batch_count(x)
    return s / (n.to(s.dtype) if isinstance(n, torch.Tensor) else n)


def gather_ranks(x: torch.Tensor) -> torch.Tensor:
    """(W, *x.shape): every rank's `x`, in rank order, by one autograd-aware
    all-reduce of zeros holding each rank's own slot (exact: x + 0 = x),
    which gloo runs on CUDA tensors as well."""
    if world() == 1:
        return x[None]
    zero = torch.zeros_like(x)[None]
    return global_sum(torch.cat([x[None] if r == rank() else zero for r in range(world())]))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of `x` (every rank's block, in rank order)."""
    if world() == 1:
        return x
    return gather_ranks(x).reshape(-1, *x.shape[1:])


def roll_next(x: torch.Tensor) -> torch.Tensor:
    """`torch.roll(x, -1, 0)` over the global batch: each sample's partner
    is the next sample, the last rank's last sample's the first rank's
    first."""
    w = world()
    if w == 1:
        return torch.roll(x, shifts=-1, dims=0)
    return torch.cat([x[1:], gather_ranks(x[0])[(rank() + 1) % w][None]])
