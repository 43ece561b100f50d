"""Launching a run over N GPUs: JAX's rule, the spawned ranks, their results.

The JAX trainer builds its data mesh over every visible device when there is
more than one and the batch divides over them (JAX `engine/trainer.py:232-234`);
`gpus_for` applies that rule to the visible GPUs. `launch` starts one process
per rank (the `spawn` start method), each joining a process group through a
`FileStore` in a temporary directory of its own (no fixed port for two
launches on one machine to collide on), calls `fn(*args)` there and returns
the ranks' results in rank order. The CUDA kernels are built in the calling
process first, so that no two ranks build into the same build directory at
once. A rank that raises makes `launch` raise with its traceback, after the
other ranks were stopped. Under torchrun the CLIs join torchrun's process
group instead (`dist.setup()` from its environment). `train_main` is the
trainer's entry point as the CLIs call it: it picks one of these three.
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from . import dist


def gpus_for(batch_size: int, device: str) -> int:
    """The JAX rule on `device`'s kind: the count of visible GPUs where it is
    more than one and divides `batch_size`, else 1 (one process)."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return 1
    n = torch.cuda.device_count()
    return n if n > 1 and batch_size % n == 0 else 1


def _rank_main(rank: int, world: int, init_method: str, backend: Optional[str],
               devices: Optional[Sequence[str]], threads: Optional[int], out_dir: str,
               fn: Callable, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    device = dist.setup(rank, world, init_method=init_method, backend=backend,
                        device=devices[rank] if devices else None)
    try:
        result = fn(device, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.teardown()


def launch(fn: Callable, args: tuple = (), *, world: int, devices: Optional[Sequence[str]] = None,
           backend: Optional[str] = None, threads: Optional[int] = None) -> List[Any]:
    """Run `fn(device, *args)` on `world` ranks and return their results.

    Each rank's device is `devices[rank]` where given (["cpu"] * W for a CPU
    run, ["cuda:0"] * W for ranks sharing one card), else `cuda:{rank}`;
    asking for more GPUs than are visible raises. `backend` defaults to NCCL
    on CUDA devices and gloo on the CPU; `threads` sets each rank's intra-op
    threads. `fn` must be importable by path (the ranks start from a fresh
    interpreter) and its result picklable. The ranks inherit this process's
    environment, with a `PYTHONHASHSEED` shared by all of them where none is
    set (string hashes, which seed the synthetic dataset's items, then agree
    across ranks)."""
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    types = {torch.device(d).type for d in devices} if devices else {"cuda"}
    if devices is None and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} GPUs asked for, {torch.cuda.device_count()} visible")
    if "cuda" in types:
        from ..ops.cuda._build import load_library

        load_library()
    tmp = tempfile.mkdtemp(prefix="dp_launch_")
    saved = os.environ.get("PYTHONHASHSEED")
    if saved is None:
        os.environ["PYTHONHASHSEED"] = str(random.SystemRandom().randrange(1, 2**32))
    try:
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn", join=True,
                           args=(world, f"file://{tmp}/rendezvous", backend,
                                 list(devices) if devices else None, threads, tmp, fn, args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        if saved is None:
            os.environ.pop("PYTHONHASHSEED", None)
        shutil.rmtree(tmp, ignore_errors=True)


def _train_rank(device: str, cfg: Dict[str, Any], run_id: str):
    from ..engine.trainer import train_main as train_one

    return train_one(cfg, device=device, run_id=run_id)


def train_main(cfg: Dict[str, Any], device: str = "cuda:0", run_id: str = "run",
               gpus: Optional[int] = None):
    """`engine/trainer.py::train_main` over as many GPUs as the run takes:
    under torchrun, this process's rank of torchrun's group; else `gpus`
    GPUs where given, or the JAX rule's (`gpus_for`), one process each when
    more than one; else this process on `device`. Returns rank 0's records."""
    from ..engine.trainer import train_main as train_one

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank_device = dist.setup(device="cpu" if torch.device(device).type == "cpu" else None)
        try:
            return train_one(cfg, device=rank_device, run_id=run_id)
        finally:
            dist.teardown()
    batch_size = cfg["training"]["batch_size"]
    world = gpus if gpus is not None else gpus_for(batch_size, device)
    if world == 1:
        return train_one(cfg, device=device, run_id=run_id)
    if batch_size % world:
        raise ValueError(f"training.batch_size {batch_size} does not split over {world} GPUs")
    return launch(_train_rank, (cfg, run_id), world=world)[0]
