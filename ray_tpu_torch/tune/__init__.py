"""ray_tpu_torch.tune — hyperparameter search (reference:
python/ray/tune/)."""

from ray_tpu_torch.tune.analysis import ExperimentAnalysis  # noqa: F401
from ray_tpu_torch.tune.sample import (  # noqa: F401
    choice,
    grid_search,
    loguniform,
    qrandint,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    PB2,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandForBOHB,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.syncer import DirSyncer, Syncer  # noqa: F401
from ray_tpu_torch.tune.trainable import (  # noqa: F401
    Trainable,
    checkpoint_dir,
    get_trial_id,
    report,
)
from ray_tpu_torch.tune import suggest  # noqa: F401
from ray_tpu_torch.tune.trial import Trial  # noqa: F401
from ray_tpu_torch.tune.trial_runner import TrialRunner  # noqa: F401
from ray_tpu_torch.tune.tune import run, with_parameters  # noqa: F401
