"""Gaussian-process searcher with expected improvement.

The reference wraps the bayes_opt package (suggest/bayesopt.py); this is
a native numpy implementation: parameters are mapped onto the unit cube
(log-space for log domains, index-scaled for categoricals), a GP with an
RBF kernel is fit to completed trials, and the next point maximizes EI
over a random candidate sweep.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.sample import Categorical, Float, Integer
from ray_tpu_torch.tune.suggest.search import (
    FINISHED,
    Searcher,
    extract_values,
    modelable_domains,
    resolve_spec,
    snap_float as _snap_float,
    snap_int as _snap_int,
)


class BayesOptSearcher(Searcher):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 n_initial_points: int = 8,
                 n_candidates: int = 256,
                 length_scale: float = 0.2,
                 xi: float = 0.01,
                 max_suggestions: Optional[int] = None,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.n_initial = n_initial_points
        self.n_candidates = n_candidates
        self.length_scale = length_scale
        self.xi = xi
        self.max_suggestions = max_suggestions
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._count = 0
        self._X: List[np.ndarray] = []  # unit-cube points
        self._y: List[float] = []       # signed scores
        self._pending: Dict[str, np.ndarray] = {}

    # ---------------------------------------------------------- unit cube
    def _to_unit(self, path_values: Dict[Tuple, float],
                 domains) -> np.ndarray:
        out = []
        for path, dom in domains:
            v = path_values[path]
            if isinstance(dom, Categorical):
                k = len(dom.categories)
                idx = dom.categories.index(v) if v in dom.categories else 0
                out.append(idx / max(1, k - 1))
            elif isinstance(dom, Float) and dom.log:
                out.append((math.log(v) - math.log(dom.lower))
                           / (math.log(dom.upper) - math.log(dom.lower)))
            elif isinstance(dom, Integer):
                # values span lower..upper-1 (exclusive upper, like
                # randrange); normalize over the inclusive max so the
                # mapping matches _from_unit exactly
                out.append((float(v) - dom.lower)
                           / max(1.0, dom.upper - 1 - dom.lower))
            else:
                out.append((float(v) - dom.lower)
                           / max(1e-12, dom.upper - dom.lower))
        return np.asarray(out)

    def _from_unit(self, u: np.ndarray, domains) -> Dict[Tuple, float]:
        overrides: Dict[Tuple, float] = {}
        for x, (path, dom) in zip(u, domains):
            x = float(min(1.0, max(0.0, x)))
            if isinstance(dom, Categorical):
                k = len(dom.categories)
                overrides[path] = dom.categories[
                    int(round(x * (k - 1)))]
            elif isinstance(dom, Float) and dom.log:
                v = math.exp(
                    math.log(dom.lower)
                    + x * (math.log(dom.upper) - math.log(dom.lower)))
                overrides[path] = self._quantize(dom, v)
            elif isinstance(dom, Integer):
                v = dom.lower + x * (dom.upper - 1 - dom.lower)
                overrides[path] = _snap_int(dom, v)
            else:
                v = dom.lower + x * (dom.upper - dom.lower)
                overrides[path] = self._quantize(dom, v)
        return overrides

    @staticmethod
    def _quantize(dom: Float, v: float) -> float:
        """Quantized domains only admit multiples of _quantum; the GP's
        continuous argmax must be snapped back onto the grid — clamping
        happens ON the grid, never off it."""
        return _snap_float(dom, v)

    # -------------------------------------------------------------- searcher
    def suggest(self, trial_id: str):
        if self._space is None:
            return FINISHED
        if self.max_suggestions is not None and \
                self._count >= self.max_suggestions:
            return FINISHED
        self._count += 1
        domains = modelable_domains(self._space)
        if len(self._y) < self.n_initial or not domains:
            config = resolve_spec(self._space, {}, self._rng)
        else:
            u = self._acquire(len(domains))
            config = resolve_spec(self._space,
                                  self._from_unit(u, domains), self._rng)
        chosen = extract_values(config, domains)
        self._pending[trial_id] = self._to_unit(chosen, domains)
        return config

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        u = self._pending.pop(trial_id, None)
        if u is None or error:
            return
        value = self.metric_of(result)
        if value is None:
            return
        self._X.append(u)
        self._y.append(self.signed(value))

    # --------------------------------------------------------------- the GP
    def _acquire(self, dim: int) -> np.ndarray:
        X = np.stack(self._X)
        y = np.asarray(self._y)
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mean) / y_std
        K = self._kernel(X, X) + 1e-6 * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        cand = self._np_rng.uniform(size=(self.n_candidates, dim))
        Ks = self._kernel(cand, X)                     # [C, N]
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)                   # [N, C]
        var = np.maximum(1e-12, 1.0 - np.sum(v * v, axis=0))
        sigma = np.sqrt(var)
        best = yn.max()
        z = (mu - best - self.xi) / sigma
        ei = sigma * (z * _norm_cdf(z) + _norm_pdf(z))
        return cand[int(np.argmax(ei))]

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.length_scale ** 2))


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


_erf = np.vectorize(math.erf)


def _norm_cdf(z):
    return 0.5 * (1.0 + _erf(z / math.sqrt(2)))
