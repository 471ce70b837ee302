"""Config expansion: grid_search cross-products + Domain sampling.

Mirrors the reference's ray.tune.suggest.variant_generator
(python/ray/tune/suggest/variant_generator.py): generate_variants walks
nested dicts, cross-multiplies every grid_search marker, then samples
Domain/lambda leaves per variant.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Tuple

from ray_tpu_torch.tune.sample import Domain


def _is_grid(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _walk(spec: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(spec, dict) and not _is_grid(spec):
        for k, v in spec.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, spec


def _set_path(d: Dict, path: Tuple, value: Any) -> None:
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _deepcopy_spec(spec: Dict) -> Dict:
    out = {}
    for k, v in spec.items():
        out[k] = _deepcopy_spec(v) if isinstance(v, dict) and not _is_grid(v) \
            else v
    return out


def count_variants(spec: Dict) -> int:
    n = 1
    for _, v in _walk(spec):
        if _is_grid(v):
            n *= len(v["grid_search"])
    return n


def generate_variants(spec: Dict, rng: random.Random = None
                      ) -> Iterator[Tuple[str, Dict]]:
    """Yields (variant_tag, resolved_config) pairs."""
    rng = rng or random.Random()
    grid_leaves: List[Tuple[Tuple, List[Any]]] = []
    for path, v in _walk(spec):
        if _is_grid(v):
            grid_leaves.append((path, v["grid_search"]))
    grids = [vals for _, vals in grid_leaves]
    for combo in itertools.product(*grids) if grids else [()]:
        config = _deepcopy_spec(spec)
        tags = []
        for (path, _), value in zip(grid_leaves, combo):
            _set_path(config, path, value)
            tags.append(f"{'/'.join(map(str, path))}={value}")
        # resolve sampled leaves after grid substitution
        for path, v in list(_walk(config)):
            if isinstance(v, Domain):
                _set_path(config, path, v.sample(rng))
            elif callable(v) and getattr(v, "__name__", "") == "<lambda>":
                resolved = _try_call(v, config)
                _set_path(config, path, resolved)
        yield ",".join(tags), config


def _try_call(fn, config):
    try:
        return fn({"config": config})
    except TypeError:
        return fn()
