"""Tree-structured Parzen estimator searcher — the HyperOpt algorithm
(Bergstra et al. 2011), implemented natively over the Domain space.

The reference wraps the hyperopt package (suggest/hyperopt.py); this
build implements the estimator itself: split completed trials into a
good quantile and the rest, model each dimension with Parzen (kernel
density) estimators l(x) over good and g(x) over bad, and suggest the
candidate maximizing l(x)/g(x). Dimensions are treated independently
(as hyperopt does for flat spaces).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.tune.sample import Categorical, Float, Integer
from ray_tpu_torch.tune.suggest.search import (
    FINISHED,
    Searcher,
    extract_values,
    modelable_domains,
    resolve_spec,
)


class TPESearcher(Searcher):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 n_initial_points: int = 10,
                 gamma: float = 0.25,
                 n_candidates: int = 24,
                 max_suggestions: Optional[int] = None,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.max_suggestions = max_suggestions
        self._rng = random.Random(seed)
        self._count = 0
        # (values per domain-path, signed score)
        self._history: List[Tuple[Dict[Tuple, float], float]] = []
        self._pending: Dict[str, Dict[Tuple, float]] = {}

    # -------------------------------------------------------------- searcher
    def suggest(self, trial_id: str):
        if self._space is None:
            return FINISHED
        if self.max_suggestions is not None and \
                self._count >= self.max_suggestions:
            return FINISHED
        self._count += 1
        domains = modelable_domains(self._space)
        if len(self._history) < self.n_initial or not domains:
            overrides: Dict[Tuple, float] = {}
        else:
            good, bad = self._split()  # one sort per suggestion, not per dim
            overrides = {path: self._suggest_dim(path, dom, good, bad)
                         for path, dom in domains}
        config = resolve_spec(self._space, overrides, self._rng)
        # record what was actually chosen (sampled dims included)
        self._pending[trial_id] = extract_values(config, domains)
        return config

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        params = self._pending.pop(trial_id, None)
        if params is None or error:
            return
        value = self.metric_of(result)
        if value is None:
            return
        self._history.append((params, self.signed(value)))

    # ------------------------------------------------------------ estimator
    def _split(self) -> Tuple[list, list]:
        ranked = sorted(self._history, key=lambda kv: kv[1], reverse=True)
        n_good = max(2, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    def _suggest_dim(self, path: Tuple, dom, good, bad) -> float:
        good_vals = [p[path] for p, _ in good if path in p]
        bad_vals = [p[path] for p, _ in bad if path in p]
        if isinstance(dom, Categorical):
            return self._suggest_categorical(dom, good_vals, bad_vals)
        return self._suggest_numeric(dom, good_vals, bad_vals)

    def _suggest_categorical(self, dom: Categorical, good_vals, bad_vals):
        k = len(dom.categories)

        def probs(vals):
            counts = [1.0] * k  # Laplace smoothing
            for v in vals:
                try:
                    counts[dom.categories.index(v)] += 1.0
                except ValueError:
                    pass
            total = sum(counts)
            return [c / total for c in counts]

        pg, pb = probs(good_vals), probs(bad_vals)
        # sample candidates from the good distribution, keep max ratio
        best, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            idx = self._rng.choices(range(k), weights=pg)[0]
            ratio = pg[idx] / pb[idx]
            if ratio > best_ratio:
                best, best_ratio = dom.categories[idx], ratio
        return best

    def _suggest_numeric(self, dom, good_vals, bad_vals) -> float:
        log = isinstance(dom, Float) and dom.log
        lo, hi = float(dom.lower), float(dom.upper)
        if log:
            lo, hi = math.log(lo), math.log(hi)
            tx = math.log
        else:
            def tx(v):
                return float(v)
        gv = [tx(v) for v in good_vals] or [(lo + hi) / 2]
        bv = [tx(v) for v in bad_vals] or [(lo + hi) / 2]

        def bandwidth(vals):
            n = len(vals)
            mean = sum(vals) / n
            var = sum((v - mean) ** 2 for v in vals) / max(1, n - 1)
            scott = math.sqrt(var) * n ** (-0.2) if var > 0 else 0.0
            return max(scott, (hi - lo) * 0.01, 1e-12)

        bw_g, bw_b = bandwidth(gv), bandwidth(bv)

        def density(x, vals, bw):
            s = 0.0
            for m in vals:
                z = (x - m) / bw
                s += math.exp(-0.5 * z * z)
            return s / (len(vals) * bw * math.sqrt(2 * math.pi)) + 1e-12

        best_x, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            # draw from the good mixture, truncated to the domain
            m = self._rng.choice(gv)
            x = min(hi, max(lo, self._rng.gauss(m, bw_g)))
            ratio = density(x, gv, bw_g) / density(x, bv, bw_b)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        value = math.exp(best_x) if log else best_x
        from ray_tpu_torch.tune.suggest.search import snap_float, snap_int

        if isinstance(dom, Integer):
            return snap_int(dom, value)
        return snap_float(dom, value)


# The reference exposes this algorithm as HyperOptSearch
# (tune/suggest/hyperopt.py); same estimator, native implementation.
HyperOptSearch = TPESearcher
