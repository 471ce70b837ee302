"""Deployment + autoscaling config (reference: python/ray/serve/config.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Replica autoscaling on observed queue sizes (reference:
    serve/autoscaling_policy.py BasicAutoscalingPolicy)."""
    min_replicas: int = 1
    max_replicas: int = 1
    target_num_ongoing_requests_per_replica: float = 1.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 60.0
    smoothing_factor: float = 1.0


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    user_config: Optional[Any] = None
    max_concurrent_queries: int = 100
    autoscaling_config: Optional[AutoscalingConfig] = None
    graceful_shutdown_timeout_s: float = 20.0
    # Health probing (resilience plane): the controller calls each
    # replica's cheap check_health() every period; timeout or a falsy
    # reply counts as a failure, and `threshold` CONSECUTIVE failures
    # mark the replica unhealthy — drained from routing and replaced
    # via the reconcile loop (reference: Ray Serve deployment_state.py
    # health_check_period_s / health_check_timeout_s). None = the
    # process-wide Config.serve_health_check_* defaults.
    health_check_period_s: Optional[float] = None
    health_check_timeout_s: Optional[float] = None
    health_check_failure_threshold: Optional[int] = None

    def resolved_health_check(self) -> tuple:
        """(period_s, timeout_s, threshold) with Config defaults filled."""
        from ray_tpu_torch._private.config import Config

        cfg = Config.instance()
        period = (self.health_check_period_s
                  if self.health_check_period_s is not None
                  else cfg.serve_health_check_period_s)
        timeout = (self.health_check_timeout_s
                   if self.health_check_timeout_s is not None
                   else cfg.serve_health_check_timeout_s)
        threshold = (self.health_check_failure_threshold
                     if self.health_check_failure_threshold is not None
                     else cfg.serve_health_check_failure_threshold)
        return float(period), float(timeout), int(threshold)
