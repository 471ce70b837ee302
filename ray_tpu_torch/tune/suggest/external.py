"""External search-library adapter seam.

The reference ships 16 adapters (tune/suggest/optuna.py, hyperopt.py,
skopt.py, ax.py, ...) that all reduce to the same shape: the external
library owns the sampling model behind an ask/tell (or
get_next/report) surface, and the adapter maps Tune's ``Searcher``
contract onto it — suggest() asks the library for a parameter
assignment, on_trial_complete() tells it the observed objective.

``AskTellSearcher`` is that shape as one generic class: wrap anything
exposing ``ask() -> dict`` and ``tell(params: dict, value: float)``
(optuna's study.ask/tell literally matches; hyperopt/skopt need a
3-line lambda pair). None of those libraries are in this image, so the
test suite drives the seam with an in-repo ask/tell optimizer — the
adapter is what a real library client drops into.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.tune.suggest.search import FINISHED, Searcher


class AskTellSearcher(Searcher):
    """Adapter from an external ask/tell optimizer to Tune's Searcher.

    opt: object with ``ask() -> Optional[dict]`` (None = exhausted) and
        ``tell(params: dict, value: float) -> None``. ``value`` is
        normalized to MAXIMIZATION before the tell; pass
        ``tell_signed=False`` to receive the raw metric instead.
    """

    def __init__(self, opt: Any, metric: Optional[str] = None,
                 mode: Optional[str] = None, tell_signed: bool = True,
                 config_of: Optional[Callable[[Dict], Dict]] = None):
        super().__init__(metric=metric, mode=mode)
        self._opt = opt
        self._tell_signed = tell_signed
        self._config_of = config_of
        self._live: Dict[str, Dict] = {}

    def suggest(self, trial_id: str):
        params = self._opt.ask()
        if params is None:
            return FINISHED
        self._live[trial_id] = dict(params)
        config = dict(params)
        if self._config_of is not None:
            config = self._config_of(config)
        # external params overlay the declared space's constants, so a
        # partial external space still yields a complete trial config
        if self._space:
            merged = {k: v for k, v in self._space.items()
                      if not hasattr(v, "sample")}
            merged.update(config)
            config = merged
        return config

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None,
                          error: bool = False) -> None:
        params = self._live.pop(trial_id, None)
        if params is None or error:
            return
        value = self.metric_of(result)
        if value is None:
            return
        self._opt.tell(params,
                       self.signed(value) if self._tell_signed else value)
