"""Test utilities incl. the chaos harness.

Reference: python/ray/_private/test_utils.py — NodeKillerActor used by
tests/test_chaos.py:27 (set_kill_interval): kills random non-head nodes
on an interval while a workload runs, asserting the system keeps making
progress (task retries, actor restarts, object reconstruction).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core import runtime as rt_mod
from ray_tpu_torch.observability.events import Severity, emit


class NodeKiller:
    """Kills (and optionally replaces) random worker nodes on a timer."""

    def __init__(self, kill_interval_s: float = 0.5,
                 replace: bool = True,
                 node_resources: Optional[Dict[str, float]] = None,
                 seed: int = 0):
        self.kill_interval_s = kill_interval_s
        self.replace = replace
        self.node_resources = node_resources or {"CPU": 2}
        self.num_killed = 0
        self.num_added = 0
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.kill_interval_s):
            self.kill_one()

    def kill_one(self) -> bool:
        rt = rt_mod.global_runtime
        if rt is None or rt.is_shutdown:
            return False
        victims = [r for nid, r in rt.cluster_state.raylets.items()
                   if r is not rt.head_raylet and not r.dead]
        if not victims:
            if self.replace:
                rt.add_node(dict(self.node_resources))
                self.num_added += 1
            return False
        victim = self._rng.choice(victims)
        emit("chaos", f"killing node {victim.node_id.hex()[:8]}",
             Severity.WARNING)
        rt.remove_node(victim.node_id)
        self.num_killed += 1
        if self.replace:
            rt.add_node(dict(self.node_resources))
            self.num_added += 1
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def wait_for_condition(predicate, timeout: float = 10.0,
                       interval: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False
