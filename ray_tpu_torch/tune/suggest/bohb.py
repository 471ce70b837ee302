"""BOHB's model component — multi-fidelity TPE.

Reference: python/ray/tune/suggest/bohb.py (TuneBOHB wrapping HpBandSter's
ConfigSpace KDE model). The defining idea (Falkner et al. 2018): density
models are built PER BUDGET — observations at 3 iterations and at 81
iterations describe different objectives — and suggestions come from the
model of the LARGEST budget that has enough observations, so early rungs
seed the model and later rungs refine it. This build implements that on
the repo's native TPE (suggest/tpe.py) instead of an external KDE
library; pair it with schedulers.HyperBandForBOHB."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ray_tpu_torch.tune.suggest.tpe import TPESearcher


class BOHBSearcher(TPESearcher):
    def __init__(self, time_attr: str = "training_iteration", **kwargs):
        super().__init__(**kwargs)
        self.time_attr = time_attr
        # budget -> trial_id -> (params, signed score); keyed by trial so
        # a trial re-reporting at the same rung replaces, not appends
        self._buckets: Dict[float, Dict[str, Tuple]] = {}

    # ------------------------------------------------------------ feedback
    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None,
                          error: bool = False) -> None:
        if result and not error:
            self._record(trial_id, result)
        self._pending.pop(trial_id, None)

    def _record(self, trial_id: str, result: Dict) -> None:
        params = self._pending.get(trial_id)
        value = self.metric_of(result)
        if params is None or value is None:
            return
        budget = float(result.get(self.time_attr, 0))
        self._buckets.setdefault(budget, {})[trial_id] = (
            params, self.signed(value))

    # ----------------------------------------------------------- suggest
    def suggest(self, trial_id: str):
        # largest budget with enough observations wins; with none deep
        # enough, pool every budget (better than pure random — the
        # low-fidelity signal still ranks configurations)
        self._history = self._model_history()
        return super().suggest(trial_id)

    def _model_history(self):
        for budget in sorted(self._buckets, reverse=True):
            entries = list(self._buckets[budget].values())
            if len(entries) >= self.n_initial:
                return entries
        return [e for bucket in self._buckets.values()
                for e in bucket.values()]
