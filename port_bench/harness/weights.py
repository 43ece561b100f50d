"""The cell's weights, made on the device from `--seed`, and their parameter
list, taken from the plain reference's model so that both sides get the
same tensors by name.

One normal draw covers every convolution kernel, scaled leaf by leaf to
He's fan-in variance (2 / fan_in), which keeps the activations of the ReLU
and ELU networks near unit scale; BatchNorm scales are 1 and every bias is
0. A configuration may name modules (`weights.zero_last_bn_gamma_of`) whose
residual blocks start with their last BatchNorm scale at 0, as a frozen,
eval-mode encoder (the ImageNet encoder of SDE pretraining) needs: its
BatchNorm normalizes with running statistics, not batch ones, so random
residual blocks would add up without bound. No pretrained file is read.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from .traffic import mix_seed


def parameter_spec(model: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in name order."""
    return sorted((name, tuple(p.shape)) for name, p in model.named_parameters())


def _is_last_bn(name: str, spec_names) -> bool:
    if name.endswith(".bn3.weight"):
        return True
    # a basic block's bn2 is its last; a bottleneck's bn2 is not
    return name.endswith(".bn2.weight") and name[:-len("bn2.weight")] + "bn3.weight" \
        not in spec_names


def make_weights(seed: int, spec: List[Tuple[str, Tuple[int, ...]]], rule: Dict[str, Any],
                 device) -> Dict[str, torch.Tensor]:
    """{name: tensor} on `device` for the parameter list `spec`."""
    convs = [(name, shape) for name, shape in spec if len(shape) == 4]
    total = sum(math.prod(shape) for _, shape in convs)
    g = torch.Generator(device=device).manual_seed(mix_seed(seed, 0))
    flat = torch.randn((total,), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in convs:
        n = math.prod(shape)
        fan_in = shape[1] * shape[2] * shape[3]
        out[name] = flat[offset:offset + n].view(shape).mul_(math.sqrt(2.0 / fan_in))
        offset += n
    gammas = rule.get("last_bn_gamma", {})
    names = {name for name, _ in spec}
    for name, shape in spec:
        if len(shape) == 4:
            continue
        if len(shape) != 1:
            raise ValueError(f"no weight rule for {name} of shape {shape}")
        if name.endswith(".weight"):
            value = 1.0
            if _is_last_bn(name, names):
                value = next((v for m, v in gammas.items() if name.startswith(m + ".")), 1.0)
            out[name] = torch.full(shape, float(value), device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `model`'s parameters by name; the two name sets
    must be equal."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing, extra = set(weights) - set(params), set(params) - set(weights)
        raise ValueError(f"parameters differ from the reference's: missing "
                         f"{sorted(missing)[:5]}, extra {sorted(extra)[:5]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: {tuple(p.shape)} against the reference's "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
