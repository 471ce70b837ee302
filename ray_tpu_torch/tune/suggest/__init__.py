"""Search-algorithm tier (reference: python/ray/tune/suggest/).

The reference ships a ``Searcher`` plugin API plus 16 third-party
integrations (Optuna, HyperOpt, Ax, BayesOpt, ...). This build keeps the
same plugin seam — ``Searcher.suggest / on_trial_result /
on_trial_complete``, ``ConcurrencyLimiter``, ``Repeater``,
``BasicVariantGenerator`` — and ships *native* model-based searchers
instead of wrappers (no third-party solver dependencies):

  - RandomSearcher                 (suggest/random_search — baseline)
  - TPESearcher / HyperOptSearch   (suggest/tpe — tree-structured Parzen
                                    estimator, the HyperOpt algorithm)
  - BayesOptSearcher               (suggest/bayesopt — GP + expected
                                    improvement on a normalized cube)

All consume the same Domain search spaces (tune/sample.py) used by the
built-in variant generator.
"""

from ray_tpu_torch.tune.suggest.search import (  # noqa: F401
    FINISHED,
    BasicVariantGenerator,
    ConcurrencyLimiter,
    Repeater,
    Searcher,
)
from ray_tpu_torch.tune.suggest.random_search import (  # noqa: F401
    RandomSearcher,
)
from ray_tpu_torch.tune.suggest.tpe import (  # noqa: F401
    HyperOptSearch,
    TPESearcher,
)
from ray_tpu_torch.tune.suggest.bayesopt import BayesOptSearcher  # noqa: F401
from ray_tpu_torch.tune.suggest.external import AskTellSearcher  # noqa: F401
