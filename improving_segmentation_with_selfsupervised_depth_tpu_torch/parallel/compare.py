"""Entry points that run the same work in one process or on each of W
ranks, for the checks that hold the data-parallel and spatially sharded
paths against one process: `tests/test_torch_port_parallel*.py` and
`tests/test_torch_port_spatial.py` (gloo on the CPU) and the
`data_parallel`, `spatial_inference` and `label_selection_dp` phases of
`chip_smoke.py` (on the card). Each takes
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
import os
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
    first batches. Returns each side's first-step losses, the host seconds
    of building both sides and their first steps (`setup_s`) and, per turn,
    the step median, device time per step, idle share, the step's peak
    memory above what was allocated before it (on the card only) and the
    turn's host seconds."""
    with _tf32(spec):
        return _ddp_overhead(device, spec, steps)


def _ddp_overhead(device: str, spec: Dict[str, Any], steps: int) -> Dict[str, Any]:
    from ..cli.profile_cli import measure

    t0 = time.perf_counter()
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
    _sync(device)
    out["setup_s"] = time.perf_counter() - t0
    for name in ("plain", "ddp", "ddp", "plain"):
        t0 = time.perf_counter()
        base = torch.cuda.memory_allocated(device)
        m = measure(sides[name], [(batch, ubatch)], steps=steps, profiled=1)
        out["turns"].append({"side": name, "median_s": m["median_s"],
                             "device_ms": m["device_ms"], "idle": m["idle"],
                             "peak_bytes": m["peak_bytes"] - base,
                             "wall_s": time.perf_counter() - t0})
    return out


def batchnorm(device: str, x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor, steps: int = 2) -> Dict[str, torch.Tensor]:
    """`BatchNorm2d` in train mode on this rank's rows of the global `x`,
    `steps` times: the loss is the global mean of its output times `g`. Returns
    the gathered output and input gradient of the last pass (the input
    gradient divided by the world size, the factor DDP's averaging takes out
    of parameter gradients), the parameter gradients averaged over the ranks
    as DDP averages them, and the running statistics."""
    bn = BatchNorm2d(x.shape[1]).to(device, x.dtype)
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


def _first_moments(path: str) -> Dict[str, torch.Tensor]:
    """The first-moment buffers (Adam's `mu`, SGD's `momentum`: the round's
    gradients, accumulated) of the optimizer state in the checkpoint at
    `path`, by parameter name, on the host."""
    state = torch.load(path, map_location="cpu", weights_only=False)["optimizer"]["state"]
    return {name: bufs["mu" if "mu" in bufs else "momentum"] for name, bufs in state.items()}


def _relative_difference(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    """|a - b| / |b| over every tensor of `b` (keys equal), in f64."""
    if sorted(a) != sorted(b):
        raise ValueError(f"parameters {sorted(set(a) ^ set(b))[:5]} on one side only")
    diff = sum(float((a[k].double() - v.double()).square().sum()) for k, v in b.items())
    norm = sum(float(v.double().square().sum()) for v in b.values())
    return (diff / norm) ** 0.5


@contextlib.contextmanager
def _rounds_read_back(store: List[Dict[str, torch.Tensor]]):
    """Each round's trained checkpoint read back on rank 0 as it is saved:
    its first moments appended to `store`."""
    from ..label_selection import driver

    saved = driver.train_on_subset

    def train_on_subset(*args, **kwargs):
        path = saved(*args, **kwargs)
        if dist.is_main():
            store.append(_first_moments(path))
        return path

    driver.train_on_subset = train_on_subset
    try:
        yield
    finally:
        driver.train_on_subset = saved


@contextlib.contextmanager
def _rank0_rows():
    """A planted fault: every rank's loaders take rank 0's rows of each
    global batch, so that the ranks train on half the batch, twice."""
    from ..data.loader import DataLoader

    saved = DataLoader.rows

    def rows(self, indices):
        rank, self.rank = self.rank, 0
        try:
            return saved(self, indices)
        finally:
            self.rank = rank

    DataLoader.rows = rows
    try:
        yield
    finally:
        DataLoader.rows = saved


@contextlib.contextmanager
def _float64_runs():
    """Every run the trainer builds inside computes in f64: its model is
    built as in f32 (the same initial weights) and cast, its batches are
    cast at the copy to the device."""
    from ..engine import trainer

    build, to_device = trainer.build_model, trainer.Run.to_device

    def to_device64(run, host):
        return {k: v.double() if v.is_floating_point() else v
                for k, v in to_device(run, host).items()}

    trainer.build_model = lambda *args, **kwargs: build(*args, **kwargs).double()
    trainer.Run.to_device = to_device64
    try:
        yield
    finally:
        trainer.build_model, trainer.Run.to_device = build, to_device


def label_selection(device: str, cfg: Dict[str, Any], dtype: str = "float32") -> Dict[str, Any]:
    """`label_selection/driver.py::label_selection_loop` of the config, TF32
    off, its runs in `dtype` ("float64": `_float64_runs`): on rank 0 alone
    first (`dist.local_only`, the log path's last part suffixed `_one`, the
    same synthetic items), then on every rank, its rounds trained
    data-parallel, then once more on every rank with a fault planted
    (`_rank0_rows`) and only the first round trained, to show what the
    comparison reads of a wrong data-parallel step. Each trained round's
    checkpoint is read back on rank 0 and its first moments held against the
    one process's round. Returns {"world": the round records, "launches":
    the kernels' launches over that loop, "hash_seed": the ranks'
    PYTHONHASHSEED, which seeds the synthetic items} and, on rank 0, "one"
    (its records), "moments" (per trained round, |world - one| / |one| of
    the first moments), "faulty" and "faulty_moments" (the same of the
    planted fault)."""
    from ..label_selection.driver import label_selection_loop

    def loop(conf, suffix=""):
        conf = copy.deepcopy(conf)
        conf["training"]["log_path"] = conf["training"]["log_path"].rstrip("/") + suffix
        moments: List[Dict[str, torch.Tensor]] = []
        with _rounds_read_back(moments):
            return label_selection_loop(conf, device), moments

    out: Dict[str, Any] = {"hash_seed": os.environ.get("PYTHONHASHSEED")}
    runs = _float64_runs() if dtype == "float64" else contextlib.nullcontext()
    with _tf32({}), runs:
        if dist.is_main():
            with dist.local_only():
                out["one"], one = loop(cfg, "_one")
        dist.barrier()
        reset_launches()
        out["world"], moments = loop(cfg)
        out["launches"] = launches()
        if dist.is_main():
            out["moments"] = [_relative_difference(m, o) for m, o in zip(moments, one)]
        faulty = copy.deepcopy(cfg)
        iters = faulty["label_selection"]["train_iters"]
        iters[1:] = [0] * (len(iters) - 1)
        with _rank0_rows():
            out["faulty"], moments = loop(faulty, "_faulty")
        if dist.is_main():
            out["faulty_moments"] = [_relative_difference(m, o) for m, o in zip(moments, one)]
    dist.barrier()
    return out


def spatial_forward(device: str, spec: Dict[str, Any]) -> Dict[str, Any]:
    """The pose-free eval forward of the spec's model (`build_student`: its
    `model_cfg`, `seed` or `state`) on one global image batch: over more than
    one rank spatially sharded (`parallel/spatial.py`, `spatial_shards`
    bands), else the plain forward. The image is `image` (NCHW numpy) or
    `color_aug_0_0` of `make_synthetic_batch(**batch)`. The model and image
    take `dtype` (default "float32"); with `calibrate` the running
    statistics are first set from the image (`_calibrate`). Runs `reps`
    (default 1) forwards, synchronized, TF32 as the spec says. Returns the
    last forward's `semantics` and `disp_*` on the host, this rank's image
    rows and whether its bands were whole, the kernel launches of the first
    forward, the halo bytes per image of one forward and their exchanges,
    the host seconds per forward and the device's peak memory allocated
    above what was allocated on entry (CUDA only), the model's included."""
    with _tf32(spec):
        return _spatial_forward(device, spec)


def _calibrate(model: torch.nn.Module, image: torch.Tensor) -> None:
    """BatchNorm's running statistics := the image batch's mean and its
    variance + 0.5, from one train-mode forward of the whole batch at
    momentum 1, in this process alone: random weights then give outputs of
    O(10), where eval mode on fresh statistics (0 and 1) lets the
    activations grow through a deep ResNet and magnifies rounding as much.
    The model is left in eval mode."""
    from ..ops.photometric import key_of

    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad(), dist.local_only():
        model({key_of("color_aug", 0, 0): image}, use_pose=False)
    for m in bns:
        m.momentum = 0.1
        m.running_var.add_(0.5)
    model.eval()


def _spatial_forward(device: str, spec: Dict[str, Any]) -> Dict[str, Any]:
    from ..ops.photometric import key_of
    from .spatial import SpatialForward

    on_cuda = torch.device(device).type == "cuda"
    base = torch.cuda.memory_allocated(device) if on_cuda else 0
    dtype = getattr(torch, spec.get("dtype", "float32"))
    model = build_student(spec, device).to(dtype).eval()
    if "image" in spec:
        image = torch.as_tensor(spec["image"]).to(device)
    else:
        image = to_device_batch({key_of("color_aug", 0, 0): make_synthetic_batch(
            **spec["batch"])[key_of("color_aug", 0, 0)]}, device)[key_of("color_aug", 0, 0)]
    image = image.to(dtype)
    if spec.get("calibrate"):
        _calibrate(model, image)
    spatial = SpatialForward(model, spec["spatial_shards"]) if dist.world() > 1 else None

    @torch.no_grad()
    def forward(x):
        if spatial is not None:
            return spatial(x)
        out = model({key_of("color_aug", 0, 0): x}, use_pose=False)
        return {k: v for k, v in out.items() if k == "semantics" or k.startswith("disp_")}

    _sync(device)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    res: Dict[str, Any] = {"seconds": [], "halo_bytes_per_image": 0, "exchanges": 0,
                           "held_rows": image.shape[2], "banded": False}
    for i in range(spec.get("reps", 1)):
        reset_launches()
        t0 = time.perf_counter()
        out = forward(image)
        _sync(device)
        res["seconds"].append(time.perf_counter() - t0)
        if i == 0:
            res["launches"] = launches()
            if spatial is not None:
                rows = -(-image.shape[0] // spatial.grid.n_data)  # this rank's images
                res.update(halo_bytes_per_image=spatial.bands.halo_bytes / rows,
                           exchanges=spatial.bands.exchanges, held_rows=spatial.held_rows,
                           banded=spatial.banded)
    res["outputs"] = _host(out)
    res["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base if on_cuda else 0
    return res


def run_all(device: str, calls) -> List[Any]:
    """Each (name of an entry point of this module, its arguments after the
    device) in turn on this rank: several checks in one launch."""
    return [globals()[name](device, *args) for name, args in calls]
