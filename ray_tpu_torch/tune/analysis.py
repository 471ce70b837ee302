"""ExperimentAnalysis — results of a tune.run.

Mirrors the reference's ray.tune.ExperimentAnalysis
(python/ray/tune/analysis/experiment_analysis.py): best trial/config/
result lookup plus tabular access to all results.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.tune.trial import Trial


class ExperimentAnalysis:
    def __init__(self, trials: List[Trial],
                 default_metric: Optional[str] = None,
                 default_mode: Optional[str] = None):
        self.trials = trials
        self.default_metric = default_metric
        self.default_mode = default_mode

    def _metric_mode(self, metric, mode):
        metric = metric or self.default_metric
        mode = mode or self.default_mode or "max"
        if metric is None:
            raise ValueError("No metric given and no default_metric set")
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        return metric, mode

    def get_best_trial(self, metric: Optional[str] = None,
                       mode: Optional[str] = None,
                       scope: str = "last") -> Optional[Trial]:
        metric, mode = self._metric_mode(metric, mode)
        sign = 1 if mode == "max" else -1
        best, best_v = None, None
        for t in self.trials:
            if scope == "all":
                hist = t.metric_history.get(metric)
                if not hist:
                    continue
                v = max(sign * x for x in hist)
            else:
                if metric not in t.last_result:
                    continue
                v = sign * t.last_result[metric]
            if best_v is None or v > best_v:
                best, best_v = t, v
        return best

    def get_best_config(self, metric: Optional[str] = None,
                        mode: Optional[str] = None,
                        scope: str = "last") -> Optional[Dict]:
        t = self.get_best_trial(metric, mode, scope)
        return t.config if t else None

    @property
    def best_trial(self) -> Trial:
        return self.get_best_trial()

    @property
    def best_config(self) -> Dict:
        return self.get_best_config()

    @property
    def best_result(self) -> Dict:
        t = self.get_best_trial()
        return t.last_result if t else {}

    def results(self) -> Dict[str, Dict]:
        return {t.trial_id: t.last_result for t in self.trials}

    def dataframe(self):
        """All trials' last results as a pandas DataFrame, or a list of
        dicts where pandas is not installed."""
        rows = []
        for t in self.trials:
            row = dict(t.last_result)
            row["trial_id"] = t.trial_id
            for k, v in t.config.items():
                if isinstance(v, (int, float, str, bool)):
                    row[f"config/{k}"] = v
            rows.append(row)
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows

    def trial_dataframes(self):
        out = {}
        for t in self.trials:
            try:
                import pandas as pd

                out[t.trial_id] = pd.DataFrame(t.results)
            except ImportError:
                out[t.trial_id] = t.results
        return out
