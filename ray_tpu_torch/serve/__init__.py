"""ray_tpu_torch.serve — model serving on actors.

Reference surface: python/ray/serve/__init__.py (@serve.deployment,
serve.start/shutdown, get_deployment, list_deployments, @serve.batch).
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    Deployment,
    deployment,
    get_deployment,
    list_deployments,
    run,
    shutdown,
    start,
)
from ray_tpu_torch.serve import pipeline  # noqa: F401
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig  # noqa: F401
from ray_tpu_torch.serve.handle import RayServeHandle  # noqa: F401
from ray_tpu_torch.serve.http_proxy import HTTPProxy, start_http_proxy  # noqa: F401
from ray_tpu_torch.exceptions import BackpressureError  # noqa: F401

__all__ = [
    "deployment", "Deployment", "start", "run", "shutdown", "get_deployment",
    "list_deployments", "batch", "AutoscalingConfig", "DeploymentConfig",
    "RayServeHandle", "HTTPProxy", "start_http_proxy", "pipeline",
    "BackpressureError",
]
