"""Trial state.

Mirrors the reference's ray.tune Trial (python/ray/tune/trial.py): id,
config, status FSM (PENDING/RUNNING/PAUSED/TERMINATED/ERROR), result log,
checkpoint slot, resource request.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, List, Optional


class Trial:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"

    def __init__(self, trainable_cls: type, config: Dict,
                 experiment_tag: str = "",
                 resources: Optional[Dict[str, float]] = None,
                 stopping_criterion: Optional[Dict] = None,
                 max_failures: int = 0):
        self.trial_id = uuid.uuid4().hex[:8]
        self.trainable_cls = trainable_cls
        self.config = config
        self.experiment_tag = experiment_tag
        self.resources = resources or {"cpu": 1}
        self.stopping_criterion = stopping_criterion or {}
        self.max_failures = max_failures
        self.num_failures = 0
        self.status = Trial.PENDING
        self.runner: Any = None            # actor handle
        self.last_result: Dict = {}
        self.results: List[Dict] = []
        self.checkpoint: Optional[Dict] = None
        self.error: Optional[str] = None
        self.metric_history: Dict[str, List[float]] = {}

    def __repr__(self):
        name = getattr(self.trainable_cls, "__name__", "trainable")
        return f"{name}_{self.experiment_tag or self.trial_id}"

    def update_result(self, result: Dict) -> None:
        self.last_result = result
        self.results.append(result)
        for k, v in result.items():
            if isinstance(v, (int, float)):
                self.metric_history.setdefault(k, []).append(float(v))

    def should_stop(self, result: Dict) -> bool:
        if result.get("done"):
            return True
        crit = self.stopping_criterion
        if callable(crit):
            return bool(crit(self.trial_id, result))
        for k, v in (crit or {}).items():
            if k in result and result[k] >= v:
                return True
        return False

    def actor_options(self) -> Dict:
        res = dict(self.resources)
        opts: Dict[str, Any] = {}
        opts["num_cpus"] = res.pop("cpu", res.pop("CPU", 1))
        gpu = res.pop("gpu", res.pop("GPU", 0))
        if gpu:
            opts["num_gpus"] = gpu
        extra = {k: v for k, v in res.items() if v}
        if extra:
            opts["resources"] = extra
        return opts

    @property
    def local_dir(self) -> str:
        return os.path.join("~", "ray_tpu_torch_results")
