"""Config grid expansion: the port's copy of the JAX package's
`config/grid.py`.

The reference tags experiment variants with ray.tune `grid_search` markers
(utils/cluster_utils.py:9-102) and only ever uses them as a tagging and
cross-product device, so a plain deterministic product over
`grid_search([...])` markers replaces ray.
"""

from __future__ import annotations

import itertools
from copy import deepcopy
from typing import Any, Dict, List, Tuple


def grid_search(values: List[Any]) -> Dict[str, Any]:
    """Marker compatible with ray.tune.grid_search."""
    return {"grid_search": list(values)}


def _find_grid_points(cfg: Any, path: Tuple = ()) -> List[Tuple[Tuple, List[Any]]]:
    points = []
    if isinstance(cfg, dict):
        if set(cfg.keys()) == {"grid_search"}:
            return [(path, cfg["grid_search"])]
        for k, v in cfg.items():
            points.extend(_find_grid_points(v, path + (k,)))
    return points


def _set_path(cfg: Dict, path: Tuple, value: Any) -> None:
    node = cfg
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def expand_grid(cfg: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every combination of the config's grid_search markers, in the order
    of `itertools.product` over the markers in key order (a config without
    one is its own single combination)."""
    points = _find_grid_points(cfg)
    if not points:
        return [deepcopy(cfg)]
    paths, value_lists = zip(*points)
    out = []
    for combo in itertools.product(*value_lists):
        variant = deepcopy(cfg)
        for path, value in zip(paths, combo):
            _set_path(variant, path, value)
        out.append(variant)
    return out
