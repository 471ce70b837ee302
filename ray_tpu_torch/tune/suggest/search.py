"""Searcher base class and composable wrappers.

Mirrors the reference's suggest/suggestion.py (Searcher,
ConcurrencyLimiter) and suggest/basic_variant.py / repeater.py. The
contract:

  suggest(trial_id) -> resolved config dict
                     | None      (nothing *right now*; ask again later)
                     | FINISHED  (search space exhausted; stop creating)

  on_trial_result(trial_id, result)           intermediate results
  on_trial_complete(trial_id, result, error)  terminal notification
"""

from __future__ import annotations

import copy
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.sample import Domain
from ray_tpu_torch.tune.variant_generator import generate_variants

FINISHED = "FINISHED"


def walk_domains(spec: Dict, path: Tuple = ()) -> List[Tuple[Tuple, Domain]]:
    """Flatten a (possibly nested) config spec into (path, Domain) leaves."""
    out: List[Tuple[Tuple, Domain]] = []
    for k, v in spec.items():
        if isinstance(v, dict) and "grid_search" not in v:
            out.extend(walk_domains(v, path + (k,)))
        elif isinstance(v, Domain):
            out.append((path + (k,), v))
    return out


def modelable_domains(spec: Dict) -> List[Tuple[Tuple, Domain]]:
    """Domains a model-based searcher can reason about. Function domains
    (sample_from/randn) have no bounds — they stay sample-only and are
    resolved by resolve_spec, never modeled."""
    from ray_tpu_torch.tune.sample import Categorical, Float, Integer

    return [(p, d) for p, d in walk_domains(spec)
            if isinstance(d, (Float, Integer, Categorical))]


def snap_int(dom, v: float) -> int:
    """Clamp a continuous suggestion into an Integer domain, staying ON
    the q-grid when the domain is quantized (clamping to upper-1 after
    rounding can otherwise land off-grid, e.g. qrandint(0,8,4) -> 7)."""
    import math

    q = getattr(dom, "_quantum", None)
    if q:
        v = round(v / q) * q
        hi = ((dom.upper - 1) // q) * q
        lo = math.ceil(dom.lower / q) * q
        return int(min(hi, max(lo, v)))
    return int(min(dom.upper - 1, max(dom.lower, round(v))))


def snap_float(dom, v: float) -> float:
    """Clamp a continuous suggestion into a Float domain, on-grid for
    quantized domains."""
    import math

    q = getattr(dom, "_quantum", None)
    if q:
        v = round(v / q) * q
        hi = math.floor(dom.upper / q) * q
        lo = math.ceil(dom.lower / q) * q
        return min(hi, max(lo, v))
    return min(dom.upper, max(dom.lower, v))


def extract_values(config: Dict, domains) -> Dict[Tuple, Any]:
    """Read back what a resolved config actually chose for each domain
    path — what model-based searchers record as observations."""
    chosen: Dict[Tuple, Any] = {}
    for path, _dom in domains:
        node = config
        for k in path:
            node = node[k]
        chosen[path] = node
    return chosen


def set_path(config: Dict, path: Tuple, value: Any) -> None:
    d = config
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def resolve_spec(spec: Dict, overrides: Dict[Tuple, Any],
                 rng: Optional[random.Random] = None) -> Dict:
    """Copy `spec` replacing Domain leaves: from `overrides` when given,
    sampled otherwise."""
    rng = rng or random
    config = copy.deepcopy({k: v for k, v in spec.items()})
    for path, domain in walk_domains(spec):
        value = overrides.get(path, None)
        if value is None:
            value = domain.sample(rng)
        set_path(config, path, value)
    return config


def _contains_grid_search(spec: Dict) -> bool:
    for v in spec.values():
        if isinstance(v, dict):
            if "grid_search" in v or _contains_grid_search(v):
                return True
    return False


class Searcher:
    """Plugin seam for search algorithms (reference: suggest/suggestion.py
    Searcher)."""

    # grid_search markers are only consumed by the variant generator;
    # model-based searchers must reject them rather than hand trials the
    # raw marker dict (reference raises the same way)
    supports_grid_search = False

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode or "max"
        self._space: Optional[Dict] = None

    # ------------------------------------------------------------ contract
    def set_search_properties(self, metric: Optional[str],
                              mode: Optional[str], config: Dict) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        if self._space is None:
            self._space = config
        if not self.supports_grid_search and self._space and \
                _contains_grid_search(self._space):
            raise ValueError(
                f"{type(self).__name__} does not support grid_search "
                "parameters; use BasicVariantGenerator (or plain "
                "tune.run without search_alg) for grid sweeps")
        return True

    def suggest(self, trial_id: str):
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None,
                          error: bool = False) -> None:
        pass

    # -------------------------------------------------------------- helpers
    def metric_of(self, result: Optional[Dict]) -> Optional[float]:
        if not result or self.metric is None:
            return None
        v = result.get(self.metric)
        return None if v is None else float(v)

    def signed(self, value: float) -> float:
        """Normalize to maximization."""
        return value if self.mode == "max" else -value


class BasicVariantGenerator(Searcher):
    """The default: grid expansion x random sampling, exactly what
    generate_variants yields (reference: suggest/basic_variant.py)."""

    supports_grid_search = True

    def __init__(self, num_samples: int = 1,
                 seed: Optional[int] = None):
        super().__init__()
        self.num_samples = num_samples
        self._rng = random.Random(seed)
        self._queue: Optional[List[Dict]] = None

    def suggest(self, trial_id: str):
        if self._queue is None:
            if self._space is None:
                return FINISHED
            self._queue = []
            for _ in range(self.num_samples):
                for _tag, cfg in generate_variants(self._space, self._rng):
                    self._queue.append(cfg)
        if not self._queue:
            return FINISHED
        return self._queue.pop(0)


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions (reference: suggest/suggestion.py
    ConcurrencyLimiter)."""

    supports_grid_search = True  # delegate; the inner searcher checks

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return None
        suggestion = self.searcher.suggest(trial_id)
        if isinstance(suggestion, dict):
            self._live.add(trial_id)
        return suggestion

    def on_trial_result(self, trial_id, result) -> None:
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class Repeater(Searcher):
    """Run each suggestion `repeat` times and report the mean to the
    wrapped searcher — for noisy objectives (reference:
    suggest/repeater.py)."""

    supports_grid_search = True  # delegate; the inner searcher checks

    def __init__(self, searcher: Searcher, repeat: int = 3):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.repeat = repeat
        self._group_of: Dict[str, str] = {}        # trial_id -> group id
        self._config_of: Dict[str, Dict] = {}      # group id -> config
        self._remaining: Dict[str, int] = {}       # group id -> to hand out
        self._outstanding: Dict[str, int] = {}     # group id -> in flight
        self._scores: Dict[str, List[float]] = {}  # group id -> results
        self._group_counter = 0

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id: str):
        for gid, left in self._remaining.items():
            if left > 0:
                self._remaining[gid] = left - 1
                self._outstanding[gid] += 1
                self._group_of[trial_id] = gid
                return copy.deepcopy(self._config_of[gid])
        suggestion = self.searcher.suggest(f"group_{self._group_counter}")
        if not isinstance(suggestion, dict):
            return suggestion
        gid = f"group_{self._group_counter}"
        self._group_counter += 1
        self._config_of[gid] = suggestion
        self._remaining[gid] = self.repeat - 1
        self._outstanding[gid] = 1
        self._scores[gid] = []
        self._group_of[trial_id] = gid
        return copy.deepcopy(suggestion)

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        gid = self._group_of.pop(trial_id, None)
        if gid is None:
            return
        self._outstanding[gid] -= 1
        value = self.metric_of(result)
        if not error and value is not None:
            self._scores[gid].append(value)
        # the group closes when every handed-out repeat has reported,
        # successes and errors alike — an errored repeat must not stall
        # the group (mean over whatever succeeded; all-errors -> error)
        if self._remaining[gid] == 0 and self._outstanding[gid] == 0:
            scores = self._scores.pop(gid, [])
            self._remaining.pop(gid, None)
            self._outstanding.pop(gid, None)
            self._config_of.pop(gid, None)
            mean_result = None
            if scores and self.metric:
                mean_result = {self.metric: sum(scores) / len(scores)}
            self.searcher.on_trial_complete(
                gid, mean_result, error=not scores)
