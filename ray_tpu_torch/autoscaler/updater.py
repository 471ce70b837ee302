"""Node bootstrap: turn a bare machine into a cluster node.

Reference: python/ray/autoscaler/_private/updater.py (``NodeUpdater``):
wait until the node answers a trivial command, sync file mounts, run
``initialization_commands`` then ``setup_commands`` then
``start_ray_commands``, and tag the node ``up-to-date`` on success or
``update-failed`` on any error so the autoscaler recycles it.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.command_runner import CommandRunnerInterface
from ray_tpu_torch.autoscaler.node_provider import (
    STATUS_UP_TO_DATE,
    TAG_NODE_STATUS,
)

logger = logging.getLogger(__name__)

STATUS_UPDATE_FAILED = "update-failed"
STATUS_WAITING_FOR_SSH = "waiting-for-ssh"
STATUS_SETTING_UP = "setting-up"


class NodeUpdaterError(RuntimeError):
    pass


class NodeUpdater:
    """Drives one node from bare to running through a CommandRunner."""

    def __init__(self, node_id: str, provider, runner: CommandRunnerInterface,
                 initialization_commands: Optional[List[str]] = None,
                 setup_commands: Optional[List[str]] = None,
                 start_commands: Optional[List[str]] = None,
                 file_mounts: Optional[Dict[str, str]] = None,
                 ready_timeout_s: float = 60.0,
                 ready_poll_s: float = 1.0):
        self.node_id = node_id
        self.provider = provider
        self.runner = runner
        self.initialization_commands = initialization_commands or []
        self.setup_commands = setup_commands or []
        self.start_commands = start_commands or []
        self.file_mounts = file_mounts or {}
        self.ready_timeout_s = ready_timeout_s
        self.ready_poll_s = ready_poll_s
        self.exit_cause: Optional[str] = None

    # ------------------------------------------------------------------ run
    def run(self) -> None:
        try:
            self._set_status(STATUS_WAITING_FOR_SSH)
            self.wait_ready()
            self._set_status(STATUS_SETTING_UP)
            self.sync_file_mounts()
            for phase, commands in (
                    ("initialization", self.initialization_commands),
                    ("setup", self.setup_commands),
                    ("start", self.start_commands)):
                for cmd in commands:
                    rc, out = self.runner.run(cmd)
                    if rc != 0:
                        raise NodeUpdaterError(
                            f"{phase} command failed rc={rc} on "
                            f"{self.node_id}: {cmd!r}\n{out}")
            self._set_status(STATUS_UP_TO_DATE)
        except BaseException as e:
            self.exit_cause = f"{type(e).__name__}: {e}"
            self._set_status(STATUS_UPDATE_FAILED)
            raise

    def wait_ready(self) -> None:
        """The node is ready when it can run a trivial command
        (reference: updater retries `uptime` until ssh answers)."""
        deadline = time.monotonic() + self.ready_timeout_s
        last = ""
        while time.monotonic() < deadline:
            try:
                rc, out = self.runner.run("true", timeout=15.0)
                if rc == 0:
                    return
                last = f"rc={rc}: {out}"
            except Exception as e:  # noqa: BLE001 — keep retrying
                last = f"{type(e).__name__}: {e}"
            time.sleep(self.ready_poll_s)
        raise NodeUpdaterError(
            f"node {self.node_id} never became reachable "
            f"({self.ready_timeout_s:.0f}s): {last}")

    def sync_file_mounts(self) -> None:
        for target, source in self.file_mounts.items():
            self.runner.run_rsync_up(source, target)

    def _set_status(self, status: str) -> None:
        set_tags = getattr(self.provider, "set_node_tags", None)
        if set_tags is not None:
            try:
                set_tags(self.node_id, {TAG_NODE_STATUS: status})
            except Exception:  # noqa: BLE001 — tags are advisory
                logger.debug("set_node_tags failed", exc_info=True)
