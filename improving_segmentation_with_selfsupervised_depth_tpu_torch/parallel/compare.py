"""Entry points that run the same work in one process or on each of W
ranks, for the checks that hold the data-parallel path against one process
on the whole batch: `tests/test_torch_port_parallel*.py` (gloo on the CPU)
and the `data_parallel` phase of `chip_smoke.py` (on the card). Each takes
the rank's device first, as `launch.launch` calls it, builds its inputs from
seeds (or takes them from the caller), works on this rank's rows and returns
host values: the global losses, gathered outputs, the student's state.

A step spec (`run_steps`, `ddp_overhead`) is a dict:
  model_cfg, n_classes, seed   the model, from `torch.manual_seed(seed)`, or
  state                        a state_dict (or its file) loaded into it;
  dropout                      False sets every dropout's p to 0;
  training                     the optimizer's part of the training config;
  step                         `StepConfig` fields;
  batches                      per step (labeled, unlabeled or None), each a
                               global numpy batch or the keyword arguments
                               of `data/synthetic.py::make_synthetic_batch`;
  noises, draws                per step, the global labeled tie-break noise
                               and `StepDraws` fields (None: drawn from the
                               step's generator, seeded with `seed`);
  tf32                         cuDNN's and matmul's TF32 (default off).
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Any, Dict, List, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from ..data.loader import to_device_batch
from ..data.synthetic import make_synthetic_batch
from ..engine.optim import build_optimizer
from ..engine.state import make_teacher
from ..engine.train_steps import StepConfig, StepDraws, train_step
from ..models.joint import build_model
from ..models.layers import BatchNorm2d, ChannelDropout, Dropout
from ..ops.cuda import reprojection, warp
from . import dist


def launches() -> Dict[str, int]:
    return {"warp": warp.warp_bilinear_nchw.launches,
            "reprojection": reprojection.reprojection_error.launches,
            "reprojection_grad": reprojection.reprojection_error_grad.launches}


def reset_launches() -> None:
    warp.warp_bilinear_nchw.launches = 0
    reprojection.reprojection_error.launches = 0
    reprojection.reprojection_error_grad.launches = 0


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def build_student(spec: Dict[str, Any], device: str) -> torch.nn.Module:
    torch.manual_seed(spec.get("seed", 0))
    model = build_model(spec["model_cfg"], spec.get("n_classes", 19), seed=spec.get("seed", 0))
    state = spec.get("state")
    if isinstance(state, str):
        state = torch.load(state, weights_only=True)
    if state is not None:
        model.load_state_dict(state)
    if not spec.get("dropout", True):
        for m in model.modules():
            if isinstance(m, (Dropout, ChannelDropout)):
                m.p = 0.0
    return model.to(device)


def _rank_batch(batch, device: str) -> Optional[Dict[str, torch.Tensor]]:
    """This rank's rows of a global batch (numpy, or make_synthetic_batch's
    keyword arguments) on `device`."""
    if batch is None:
        return None
    if "seed" in batch:  # make_synthetic_batch's keyword arguments
        batch = make_synthetic_batch(**batch)
    return {k: dist.rank_rows(v) for k, v in to_device_batch(batch, device).items()}


def _draws(fields: Optional[Dict[str, Any]], device: str) -> StepDraws:
    fields = {k: v.to(device) if isinstance(v, torch.Tensor) else v
              for k, v in (fields or {}).items()}
    return StepDraws(**fields)


@contextlib.contextmanager
def _tf32(spec):
    """cuDNN's and matmul's TF32 as the spec says, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = spec.get(
        "tf32", False)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class _Trainee:
    """A student (wrapped in DDP or not), its teacher, optimizer, step config
    and generator: one side of a comparison."""

    def __init__(self, spec: Dict[str, Any], device: str, ddp: bool,
                 model: Optional[torch.nn.Module] = None):
        self.model = model if model is not None else build_student(spec, device)
        self.cfg = StepConfig(**spec["step"])
        self.teacher = make_teacher(self.model) if self.cfg.use_ema else None
        self.optimizer = build_optimizer(spec["training"], spec["model_cfg"], self.model)
        self.stepped = self.model
        if ddp:
            on_cuda = torch.device(device).type == "cuda"
            self.stepped = DistributedDataParallel(
                self.model, device_ids=[device] if on_cuda else None, broadcast_buffers=False)
        self.generator = torch.Generator(device=device).manual_seed(spec.get("seed", 0))

    def step(self, batch, unlabeled, noise=None, draws: StepDraws = StepDraws()):
        return train_step(self.stepped, self.optimizer, batch, self.cfg,
                          generator=self.generator, tie_break_noise=noise,
                          unlabeled_batch=unlabeled, teacher=self.teacher, draws=draws)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(device: str, spec: Dict[str, Any]) -> Dict[str, Any]:
    """The spec's steps on this rank's rows, the student wrapped in DDP over
    more than one rank. Returns per step the global losses, the kernel
    launches and the host seconds (synchronized), then the student's
    state_dict, its gradients of the last step (the averaged ones DDP
    leaves), the teacher's parameters and the BatchNorm running statistics."""
    with _tf32(spec):
        return _run_steps(device, spec)


def _run_steps(device: str, spec: Dict[str, Any]) -> Dict[str, Any]:
    side = _Trainee(spec, device, ddp=dist.world() > 1)
    noises = spec.get("noises") or [None] * len(spec["batches"])
    draws = spec.get("draws") or [None] * len(spec["batches"])
    out: Dict[str, List[Any]] = {"losses": [], "launches": [], "seconds": []}
    for (labeled, unlabeled), noise, fields in zip(spec["batches"], noises, draws):
        batch, ubatch = _rank_batch(labeled, device), _rank_batch(unlabeled, device)
        _sync(device)
        reset_launches()
        t0 = time.perf_counter()
        metrics = side.step(batch, ubatch, None if noise is None else noise.to(device),
                            _draws(fields, device))
        losses = {k: float(v) for k, v in metrics.items() if not k.startswith("debug/")}
        _sync(device)
        out["seconds"].append(time.perf_counter() - t0)
        out.setdefault("debug", []).append(
            {k: _host(dist.gather_rows(v)) for k, v in metrics.items() if k.startswith("debug/")})
        out["launches"].append(launches())
        out["losses"].append(losses)
    model = side.model
    out["state"] = _host(model.state_dict())
    out["grads"] = {k: _host(p.grad) for k, p in model.named_parameters() if p.grad is not None}
    if side.teacher is not None:
        out["teacher"] = {k: _host(p) for k, p in side.teacher.named_parameters()}
    out["bn_stats"] = {k: v for k, v in out["state"].items()
                       if k.endswith(("running_mean", "running_var"))}
    return out


def ddp_overhead(device: str, spec: Dict[str, Any], steps: int = 3) -> Dict[str, Any]:
    """In one process of a world-size-1 group: the spec's first step with the
    student plain and wrapped in DDP (the distributed path, its collectives
    over the group's backend) from the same weights, then both timed in
    turns (plain, DDP, DDP, plain) by `cli/profile_cli.py::measure` on the
    first batches. Returns each side's first-step losses and, per turn, the
    step median, device time per step, idle share and the step's peak
    memory above what was allocated before it (on the card only)."""
    with _tf32(spec):
        return _ddp_overhead(device, spec, steps)


def _ddp_overhead(device: str, spec: Dict[str, Any], steps: int) -> Dict[str, Any]:
    from ..cli.profile_cli import measure

    sides = {"plain": _Trainee(spec, device, ddp=False)}
    sides["ddp"] = _Trainee(spec, device, ddp=True, model=build_student(spec, device))
    labeled, unlabeled = spec["batches"][0]
    batch, ubatch = _rank_batch(labeled, device), _rank_batch(unlabeled, device)
    out: Dict[str, Any] = {"losses": {}, "turns": []}
    for name, side in sides.items():
        torch.manual_seed(spec.get("seed", 0))  # the same dropout draws
        metrics = side.step(batch, ubatch)
        out["losses"][name] = {k: float(v) for k, v in metrics.items()
                               if not k.startswith("debug/")}
    for name in ("plain", "ddp", "ddp", "plain"):
        _sync(device)
        base = torch.cuda.memory_allocated(device)
        m = measure(sides[name], [(batch, ubatch)], steps=steps, profiled=1)
        out["turns"].append({"side": name, "median_s": m["median_s"],
                             "device_ms": m["device_ms"], "idle": m["idle"],
                             "peak_bytes": m["peak_bytes"] - base})
    return out


def batchnorm(device: str, x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor, steps: int = 2) -> Dict[str, torch.Tensor]:
    """`BatchNorm2d` in train mode on this rank's rows of the global `x`,
    `steps` times: the loss is the global mean of its output times `g`. Returns
    the gathered output and input gradient of the last pass (the input
    gradient divided by the world size, the factor DDP's averaging takes out
    of parameter gradients), the parameter gradients averaged over the ranks
    as DDP averages them, and the running statistics."""
    bn = BatchNorm2d(x.shape[1]).to(device)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_var.zero_()  # then it holds the batch variances alone, to f32 precision
    for _ in range(steps):
        xr = dist.rank_rows(x.to(device)).clone().requires_grad_()
        bn.zero_grad()
        y = bn(xr)
        loss = dist.batch_mean(y * dist.rank_rows(g.to(device)))
        loss.backward()
    w = dist.world()

    def averaged(t):
        return dist.global_sum(t.detach().clone()) / w

    return _host({"y": dist.gather_rows(y.detach()), "x_grad": dist.gather_rows(xr.grad) / w,
                  "weight_grad": averaged(bn.weight.grad), "bias_grad": averaged(bn.bias.grad),
                  "running_mean": bn.running_mean, "running_var": bn.running_var,
                  "loss": loss.detach()})


def validate(device: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """`Run.validate` of the config's run, built on every rank from its seed,
    over this rank's rows; on rank 0 also in one process (`dist.local_only`:
    the same run built again and validated alone). Returns {"world": (record,
    confusion matrix)[, "one": the same in one process]}."""
    from ..engine.trainer import build_run

    def once():
        run = build_run(copy.deepcopy(cfg), device)
        try:
            record = run.validate(0)
            return record, run.val_confusion
        finally:
            run.close()

    out = {"world": once()}
    if dist.is_main():
        with dist.local_only():
            out["one"] = once()
    return out


def train(device: str, cfg: Dict[str, Any]) -> List[Dict[str, float]]:
    """`engine/trainer.py::train_main` of the config on this rank."""
    from ..engine.trainer import train_main

    return train_main(copy.deepcopy(cfg), device=device)


def run_all(device: str, calls) -> List[Any]:
    """Each (name of an entry point of this module, its arguments after the
    device) in turn on this rank: several checks in one launch."""
    return [globals()[name](device, *args) for name, args in calls]
