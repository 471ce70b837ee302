"""StandardAutoscaler — the reconcile loop.

Reference: python/ray/autoscaler/_private/autoscaler.py:138
(StandardAutoscaler.update:284): each tick reads load metrics, plans
launches with the demand scheduler, creates/terminates nodes through the
NodeProvider, and scales down nodes idle past the timeout (never below
min_workers).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.load_metrics import LoadMetrics
from ray_tpu_torch.autoscaler.node_provider import (
    NODE_KIND_WORKER,
    NodeProvider,
    TAG_NODE_KIND,
    TAG_USER_NODE_TYPE,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import get_nodes_to_launch

logger = logging.getLogger(__name__)


class StandardAutoscaler:
    def __init__(self, config: Dict[str, Any], provider: NodeProvider,
                 load_metrics: Optional[LoadMetrics] = None):
        """config mirrors the reference's cluster YAML:
        {available_node_types: {name: {resources, min_workers,
        max_workers}}, max_workers, idle_timeout_minutes}."""
        from ray_tpu_torch._private.config import Config

        self.config = config
        self.provider = provider
        self.load_metrics = load_metrics or LoadMetrics()
        self.node_types: Dict[str, dict] = config["available_node_types"]
        self.max_workers: int = config.get("max_workers", 20)
        # cluster-YAML keys win; the Config knob is the default when
        # the YAML names neither (reference: idle_timeout_minutes)
        if "idle_timeout_s" in config or "idle_timeout_minutes" in config:
            self.idle_timeout_s: float = config.get(
                "idle_timeout_s",
                config.get("idle_timeout_minutes", 5) * 60.0)
        else:
            self.idle_timeout_s = \
                Config.instance().autoscaler_idle_timeout_s
        self.demand_threshold: int = config.get(
            "demand_threshold",
            Config.instance().autoscaler_demand_threshold)
        self.num_launches = 0
        self.num_terminations = 0

    # ------------------------------------------------------------- update
    def update(self, runtime=None) -> Dict[str, int]:
        """One reconcile tick; returns the launch plan it executed.
        Demand comes from the provider's GCS (process-backed clusters:
        real raylet-process queue depth via node_stats) when the
        provider exposes one, else from the in-process runtime."""
        gcs_address = getattr(self.provider, "gcs_address", None)
        if gcs_address:
            self.load_metrics.update_from_gcs(gcs_address)
        else:
            if runtime is None:
                from ray_tpu_torch.core import runtime as rt_mod

                runtime = rt_mod.global_runtime
            if runtime is not None:
                self.load_metrics.update_from_runtime(runtime)

        workers = self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: NODE_KIND_WORKER})
        existing: Dict[str, int] = {}
        for nid in workers:
            t = self.provider.node_tags(nid).get(TAG_USER_NODE_TYPE, "?")
            existing[t] = existing.get(t, 0) + 1

        available = [avail for _, (_, avail) in
                     self.load_metrics.node_resources.items()]
        demands = self.load_metrics.pending_demands
        pg_demands = self.load_metrics.pending_pg_demands
        if len(demands) + len(pg_demands) < self.demand_threshold:
            # below the scale-up hysteresis threshold: don't launch for
            # a trickle of demand — plan only the min_workers floor
            # (the default threshold of 1 makes this a no-op)
            demands, pg_demands = [], []
        plan = get_nodes_to_launch(
            self.node_types,
            existing,
            available,
            demands,
            pg_demands,
            self.max_workers,
        )
        for tname, count in plan.items():
            self._launch(tname, count)
        self._terminate_idle(workers, existing, runtime)
        return plan

    def _launch(self, node_type: str, count: int) -> None:
        cfg = self.node_types[node_type]
        logger.info("autoscaler launching %d x %s", count, node_type)
        self.provider.create_node(
            {"resources": dict(cfg.get("resources", {}))},
            {TAG_NODE_KIND: NODE_KIND_WORKER,
             TAG_USER_NODE_TYPE: node_type},
            count)
        self.num_launches += count

    def _terminate_idle(self, workers: List[str],
                        existing: Dict[str, int], runtime) -> None:
        if runtime is None and not getattr(self.provider, "gcs_address",
                                           None):
            return
        idle = set(self.load_metrics.idle_nodes(self.idle_timeout_s))
        if not idle:
            return
        raylet_to_provider = {}
        for nid in workers:
            raylet_id = getattr(self.provider, "raylet_node_id",
                                lambda _x: None)(nid)
            if raylet_id is not None:
                key = (raylet_id if isinstance(raylet_id, str)
                       else raylet_id.hex())
                raylet_to_provider[key] = nid
        for raylet_hex in idle:
            provider_id = raylet_to_provider.get(raylet_hex)
            if provider_id is None:
                continue  # head node or unknown
            t = self.provider.node_tags(provider_id).get(
                TAG_USER_NODE_TYPE, "?")
            if existing.get(t, 0) <= self.node_types.get(t, {}).get(
                    "min_workers", 0):
                continue
            logger.info("autoscaler terminating idle node %s", provider_id)
            self.provider.terminate_node(provider_id)
            existing[t] = existing.get(t, 0) - 1
            self.num_terminations += 1
            self.load_metrics.last_used_time.pop(raylet_hex, None)


class Monitor:
    """Background loop driving autoscaler.update (reference:
    autoscaler/_private/monitor.py runs beside the GCS)."""

    def __init__(self, autoscaler: StandardAutoscaler,
                 interval_s: Optional[float] = None):
        from ray_tpu_torch._private.config import Config

        self.autoscaler = autoscaler
        self.interval_s = (Config.instance().autoscaler_update_interval_s
                           if interval_s is None else interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception:  # noqa: BLE001 — monitor must survive
                logger.exception("autoscaler update failed")
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
