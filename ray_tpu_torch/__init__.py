"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``.

Same public API as ``ray_tpu`` (itself mirroring python/ray/__init__.py):
dynamic task graphs (``@ray_tpu_torch.remote``), stateful actors, an
in-process object store and placement groups, on the thread-worker tier.
The scheduling plane's batched placement solve runs as torch ops on the
runtime's device (``init(device=...)``, CUDA unless the caller asks for
the CPU), and the model path (``ray_tpu_torch.models``) runs attention
through a hand-written CUDA kernel for Hopper.

The package imports nothing from ``ray_tpu``: the JAX-free modules it
needs are its own copies.
"""

__version__ = "0.1.0"

from ray_tpu_torch._private.ids import (  # noqa: F401
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    UniqueID,
    WorkerID,
)
from ray_tpu_torch import exceptions  # noqa: F401

# The core runtime API (init/remote/get/put/wait/...) is re-exported from
# ray_tpu_torch.core.api once that module is imported; keep the import at the
# bottom to avoid cycles.
from ray_tpu_torch.core.api import (  # noqa: F401,E402
    ObjectRef,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)


def get_gpu_ids():
    """Accelerator ids assigned to this worker (reference: ray.get_gpu_ids).

    SHIM — index-count-only: this runtime does not pin specific device
    ordinals to workers (all workers of a node share the node's device
    set; JAX addresses devices through the mesh, not through
    CUDA_VISIBLE_DEVICES-style masking), so the returned ids are always
    ``0..k-1`` where ``k`` is the ceil of the worker's GPU/TPU resource
    assignment — NOT a per-worker device selection. Code that uses the
    reference's contract (ids index into the node's physical devices
    assigned exclusively to this worker) should use the mesh/sharding
    APIs instead. A fractional assignment still owns (a share of) one
    device. See PARITY.md."""
    import math

    ctx = get_runtime_context()
    assigned = ctx.get_assigned_resources()
    n = float(assigned.get("GPU", assigned.get("TPU", 0)))
    return list(range(math.ceil(n)))


__all__ = [
    "ActorID", "JobID", "NodeID", "ObjectID", "PlacementGroupID", "TaskID",
    "UniqueID", "WorkerID", "ObjectRef", "exceptions", "init", "shutdown",
    "is_initialized", "remote", "get", "put", "wait", "kill", "cancel",
    "get_actor", "method", "nodes", "cluster_resources",
    "available_resources", "get_runtime_context",
    "get_gpu_ids", "__version__",
]
