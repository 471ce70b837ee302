"""Multiprocess execution tier: OS-process workers behind the same
interfaces as the in-process thread workers.

The reference runs every worker as a separate OS process forked by the
raylet's WorkerPool (src/ray/raylet/worker_pool.h:144) and moves objects
between them through the plasma shared-memory store
(src/ray/object_manager/plasma/). This package is that tier for the
PyTorch/CUDA port:

  - ``ProcessWorkerPool``   — a pool of leased worker processes that
    execute normal tasks (worker_pool.h PopWorker/PushWorker semantics:
    a raylet worker thread leases a process, pipelines the task onto it,
    returns it to the idle pool).
  - ``ActorProcess``        — one dedicated process per actor holding the
    live instance (the reference gives every actor its own worker
    process; direct_actor_transport pushes calls to it).
  - shm transport           — pickle protocol-5 out-of-band buffers are
    carried through the native C++ shared-memory store
    (ray_tpu_torch/_native/shm_store.cpp), not the control pipe, so large
    numpy/bytes payloads move zero-copy through shm exactly like plasma.

The multi-process cluster — a GCS process and one raylet process per
node, driven by ``process_cluster.ProcessCluster`` and
``process_cluster.ClusterClient`` — is built from the same pool, one per
raylet.

Process death is detected on the pipe (EOF/EPIPE) and surfaces as
``WorkerCrashedError`` — the same signal the reference's owner gets when
a leased worker dies — which drives task retries
(TaskManager::RetryTaskIfPossible) and actor restarts
(GcsActorManager::ReconstructActor).

Enable with ``ray_tpu_torch.init(worker_mode="process")``.

Known v1 limitation (documented, reference-parity gap): worker processes
do not embed a full peer runtime, so user code running inside a process
worker cannot itself call ``ray_tpu_torch.remote`` (nested task submission
requires ``worker_mode="thread"``).
"""

from ray_tpu_torch.cluster.process_pool import (  # noqa: F401
    ActorProcess,
    ProcessActorProxy,
    ProcessWorkerPool,
    WorkerProcess,
)
