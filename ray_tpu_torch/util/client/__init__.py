"""ray_tpu_torch.util.client — remote driver over a socket.

Reference surface: python/ray/util/client/ (ray://-address drivers
proxied through a server onto the cluster).
"""

from ray_tpu_torch.util.client.client import (  # noqa: F401
    ClientActorHandle,
    ClientContext,
    ClientObjectRef,
    connect,
)
from ray_tpu_torch.util.client.server import ClientServer  # noqa: F401

__all__ = ["connect", "ClientContext", "ClientServer", "ClientObjectRef",
           "ClientActorHandle"]
