"""Independent random sampling over the Domain space — the baseline
every model-based searcher is judged against."""

from __future__ import annotations

import random
from typing import Optional

from ray_tpu_torch.tune.suggest.search import FINISHED, Searcher, resolve_spec


class RandomSearcher(Searcher):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 max_suggestions: Optional[int] = None,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.max_suggestions = max_suggestions
        self._rng = random.Random(seed)
        self._count = 0

    def suggest(self, trial_id: str):
        if self._space is None:
            return FINISHED
        if self.max_suggestions is not None and \
                self._count >= self.max_suggestions:
            return FINISHED
        self._count += 1
        return resolve_spec(self._space, {}, self._rng)
