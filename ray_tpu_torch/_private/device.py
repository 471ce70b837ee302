"""The one place a device is resolved.

Every entry point of the package (``init``, the model constructors,
``build_forward``) takes ``device=None`` and passes it through
:func:`resolve_device`: ``None`` means CUDA, and a missing CUDA is an
error. Nothing drops to the CPU on its own; a caller that wants the CPU
(the parity tests) asks for it. The two exceptions read the device a
spawner gave its process: :func:`auto_init_device`, the device of a
runtime that starts without ``init`` (cluster/child_env.py), and
:func:`control_plane_device`, the device of a GCS process's placement
solves (cluster/process_cluster.py). ``torch`` is imported on the first
call, not with the package (see scheduler/policy.py).
"""

from __future__ import annotations

import os


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on CUDA by default and this process sees "
            "no CUDA device; pass device='cpu' to run on the CPU")
    return dev


def auto_init_device():
    """The device of a runtime that starts on its own (a remote call or a
    runtime-context read before ``init``): ``None`` (CUDA), except in a
    process-tier worker that the device rule (cluster/child_env.py) left
    without a card. That worker's runtime runs on the CPU, as the JAX
    package's worker runs JAX there, so a train worker can read its
    runtime context; its CUDA entry points still raise."""
    if os.environ.get("RAY_TPU_WORKER_PROCESS") == "1" and \
            os.environ.get("CUDA_VISIBLE_DEVICES") == "":
        return "cpu"
    return None


def control_plane_device() -> str:
    """The device a GCS process runs its placement solves on, read from
    its own ``CUDA_VISIBLE_DEVICES``, which its spawner set
    (cluster/process_cluster.py: ``ProcessCluster(gcs_device=...)``).

    The JAX package's spawner gives its control plane the platform that
    ``RAY_TPU_WORKER_JAX_PLATFORMS`` names, and its GCS runs the fused
    solve there (ray_tpu/cluster/process_cluster.py:46-52). The
    counterpart here: a GCS whose ``CUDA_VISIBLE_DEVICES`` is ``""``
    (the caller asked for the CPU) solves as torch ops on the CPU; any
    other value means CUDA, as every entry point's ``None`` does, and
    raises if CUDA cannot reach a card. Whether CUDA is available
    decides nothing. On the CPU torch is not imported here."""
    if os.environ.get("CUDA_VISIBLE_DEVICES") == "":
        return "cpu"
    return str(resolve_device(None))
