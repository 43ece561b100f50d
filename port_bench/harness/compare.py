"""The comparison that decides `correct` for a training cell.

Each side (the port's run, the plain reference, or the reference in a lower
precision or with a planted fault) follows the same checked steps from the
same weights, batches and draws and gives its `Readings`:

  losses        each checked step's total loss
  components    the first step's loss components (the step's `*_loss`
                records)
  grads         per trainable leaf, the first step's gradient as the
                optimizer got it (clipped), worked out from the optimizer's
                state after one step: SGD's momentum trace less the weight
                decay of the initial weights, Adam's first moment over
                (1 - b1); on the host, in f32
  grad_norms    their norms
  change_norms  per trainable leaf, the norm of its change over the checked
                steps (the parameters that the next step starts from, less
                the initial ones)

and `gaps` sets one side's readings against the reference's:

  loss_gap         the largest |L - L_ref| / |L_ref| over the checked steps
  loss1_gap        the same of the first step alone (its weights are the
                   seed's: no earlier step's rounding is in it)
  loss1.<name>     the same of each of the first step's loss components
  grad_gap         over the leaves, the largest |n - n_ref| / max(n_ref,
                   the median leaf's n_ref) of the gradient norms
  grad_gap_median  the median leaf's of the same
  grad_diff        over the leaves, the largest |g - g_ref| / max(|g_ref|,
                   the median leaf's |g_ref|): the norm of the difference of
                   the first gradients, which, unlike the gap of two norms,
                   cannot cancel
  grad_diff_median the median leaf's of the same
  change_gap       the largest of the same of the change norms, over the
                   leaves whose reference gradient norm is at least a
                   thousandth of the median leaf's (below that a leaf moves
                   under Adam by round-off alone)
  change_gap_median  the median leaf's of the same

A leaf that one side trains and the other does not reads 1. A cell's
workload file names the numbers that decide `correct` and their limits;
the others are printed beside them.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Dict, List, Tuple

import torch

MOVED_SHARE = 1e-3  # of the median leaf's gradient norm, below which a leaf is left out


@dataclasses.dataclass
class Readings:
    losses: List[float]
    components: Dict[str, float]
    grads: Dict[str, torch.Tensor]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def trainable(optimizer) -> List[Tuple[str, torch.nn.Parameter]]:
    """(name, parameter) of every leaf in the optimizer's groups."""
    return [(name, p) for g in optimizer.groups for name, p in zip(g["names"], g["params"])]


@torch.no_grad()
def first_gradients(optimizer, initial: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first step's gradient per leaf, from the optimizer's state after
    that step (the module docstring), on the host."""
    buffers = optimizer.buffers
    if "momentum" in buffers:
        state, scale, decay = buffers["momentum"], 1.0, optimizer.weight_decay
    elif "mu" in buffers:
        state, scale, decay = buffers["mu"], 1.0 / (1.0 - optimizer.b1), 0.0
    else:
        raise NotImplementedError(f"no first-gradient reading for {type(optimizer).__name__}")
    out = {}
    for name, p in trainable(optimizer):
        if p not in state:  # a leaf the step never updated reads a zero gradient
            out[name] = torch.zeros(p.shape)
            continue
        g = state[p].double() * scale
        if decay:
            g = g - decay * initial[name].double()
        out[name] = g.float().cpu()
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


@torch.no_grad()
def change_norms(optimizer, initial: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {name: float(torch.linalg.vector_norm(p.double() - initial[name].double()))
            for name, p in trainable(optimizer)}


def _rel(a: float, b: float) -> float:
    gap = abs(a - b) / abs(b) if b != 0 else abs(a - b)
    return gap if math.isfinite(gap) else math.inf


def _leaf_gaps(side: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """{leaf: gap} of the module docstring over `names`."""
    names = sorted(names)
    known = [ref[n] for n in names if n in ref]
    median = statistics.median(known) if known else 0.0
    out = {}
    for n in names:
        if n not in side or n not in ref:
            out[n] = 1.0
            continue
        scale = max(ref[n], median)
        gap = abs(side[n] - ref[n]) / scale if scale > 0 else float(side[n] != 0)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    if not gaps:
        return 0.0, ""
    at = max(gaps, key=lambda n: gaps[n])
    return gaps[at], at


def gaps(side: Readings, ref: Readings) -> Dict[str, Tuple[float, str]]:
    """{name: (reading, where)} of the module docstring's numbers."""
    steps = [_rel(a, b) for a, b in zip(side.losses, ref.losses)]
    if len(steps) != len(ref.losses) or not steps:
        steps = [math.inf]
    worst = max(range(len(steps)), key=lambda i: steps[i])
    out = {"loss_gap": (steps[worst], f"step {worst + 1}"), "loss1_gap": (steps[0], "step 1")}
    for name, value in sorted(ref.components.items()):
        if value != 0:
            out[f"loss1.{name}"] = (_rel(side.components.get(name, math.inf), value), "step 1")
    leaves = set(side.grad_norms) | set(ref.grad_norms)
    grad = _leaf_gaps(side.grad_norms, ref.grad_norms, leaves)
    g_median = statistics.median(ref.grad_norms.values()) if ref.grad_norms else 0.0
    moved = {n for n in leaves if ref.grad_norms.get(n, math.inf) >= MOVED_SHARE * g_median}
    change = _leaf_gaps(side.change_norms, ref.change_norms, moved)
    out["grad_gap"] = _worst(grad)
    out["grad_gap_median"] = (statistics.median(grad.values()) if grad else 0.0, "")
    diff = {n: float(torch.linalg.vector_norm(side.grads[n].double() - ref.grads[n].double()))
            for n in leaves if n in side.grads and n in ref.grads}
    diff_gap = _leaf_gaps({n: ref.grad_norms[n] + d for n, d in diff.items()},
                          ref.grad_norms, leaves)
    out["grad_diff"] = _worst(diff_gap)
    out["grad_diff_median"] = (statistics.median(diff_gap.values()) if diff_gap else 0.0, "")
    out["change_gap"] = _worst(change)
    out["change_gap_median"] = (statistics.median(change.values()) if change else 0.0, "")
    return out


def verdict(readings: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> bool:
    """Every number that has a limit within it (a number the reference did
    not give reads as failed)."""
    return all(name in readings and readings[name][0] <= limit
               for name, limit in limits.items())


def components(record: Dict[str, Any]) -> Dict[str, float]:
    """The loss components of a step's record, on the host."""
    return {k: float(v) for k, v in record.items() if k.endswith("_loss") and k != "total_loss"}
