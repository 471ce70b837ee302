"""ray_tpu_torch.gcs — global control state introspection.

Reference surface: python/ray/state.py (GlobalState) +
internal/internal_api.py (memory dump). The authoritative data lives in
the runtime (the in-process GCS); this module is the read path. The
JAX package's ``timeline`` (its profiling module) is not ported.
"""

from ray_tpu_torch.gcs.state import (  # noqa: F401
    GlobalState,
    actors,
    memory_summary,
    nodes,
    state,
)

__all__ = ["GlobalState", "state", "actors", "nodes", "memory_summary"]
