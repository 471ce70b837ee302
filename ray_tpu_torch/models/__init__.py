from ray_tpu_torch.models.checkpoint import (  # noqa: F401
    CheckpointManager,
    restore_train_state,
    save_train_state,
)
