"""ray_tpu_torch.train — training orchestration (reference:
python/ray/train/)."""

from ray_tpu_torch.train.backend import (  # noqa: F401
    Backend,
    BackendConfig,
    BackendExecutor,
    TopologyConfig,
)
from ray_tpu_torch.train.callbacks import (  # noqa: F401
    JsonLoggerCallback,
    PrintCallback,
    TrainingCallback,
)
from ray_tpu_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
    CheckpointStrategy,
)
from ray_tpu_torch.train.session import (  # noqa: F401
    get_dataset_shard,
    load_checkpoint,
    local_rank,
    report,
    save_checkpoint,
    world_rank,
    world_size,
)
from ray_tpu_torch.train.trainer import Trainer, TrainingIterator  # noqa: F401
from ray_tpu_torch.train.worker_group import WorkerGroup  # noqa: F401
