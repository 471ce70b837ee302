"""ray_tpu_torch.workflow — durable workflows with checkpointed steps.

Reference surface: python/ray/workflow/__init__.py (@workflow.step,
run/resume, virtual actors, storage backends).
"""

from ray_tpu_torch.workflow.api import (  # noqa: F401
    EventListener,
    WorkflowStep,
    WorkflowStepNode,
    cancel,
    delete,
    get_actor,
    get_output,
    get_status,
    init,
    list_all,
    resume,
    run,
    sleep,
    step,
    virtual_actor,
    wait_for_event,
)
from ray_tpu_torch.workflow.storage import (  # noqa: F401
    FilesystemStorage,
    Storage,
    get_global_storage,
    set_global_storage,
)

__all__ = [
    "step", "init", "resume", "run", "cancel", "get_status",
    "get_output", "list_all", "delete", "virtual_actor", "get_actor",
    "sleep", "wait_for_event", "EventListener",
    "WorkflowStep", "WorkflowStepNode",
    "Storage", "FilesystemStorage", "get_global_storage",
    "set_global_storage",
]
