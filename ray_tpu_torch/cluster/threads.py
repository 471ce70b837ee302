"""Named-thread registry with joined teardown.

The raylet and GCS daemons spawn a dozen background threads (heartbeat,
failure detector, dispatch loops, dereg/log flushers, retry sweeps).
They are daemonic so a crashed process still exits, but daemonic alone
means a shutdown that leaves one running produces a silent leak — the
thread keeps mutating state under a half-torn-down server and the flake
surfaces three tests later. The registry makes teardown observable:
every spawn is tracked by name, and ``join_all`` joins them under a
budget, WARN-logging any thread still alive so a hung teardown names
its culprit instead of leaking it (reference: the C++ raylet joins its
io_service threads in NodeManager shutdown; hung ones show up in the
stack dump by thread name)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


def root_label(target: Callable) -> str:
    """Canonical thread-root name for TARGET: ``<module stem>.<qualname>``
    (e.g. ``raylet_server.RayletServer._heartbeat_loop``). This is THE
    root naming — raycheck's RC16/RC17 reports derive the identical
    label statically (``facts._root_label``, pinned by a test), so a
    data-race report, ``cli.py status``, and a ``perf_dump`` lane all
    name the same thread the same way."""
    # derive the module stem from the DEFINING FILE, not __module__: a
    # raylet launched as `python -m ray_tpu_torch.cluster.raylet_server` has
    # __module__ == "__main__" for its own classes, which would break
    # label identity between in-process and subprocess nodes
    code = getattr(getattr(target, "__func__", target), "__code__", None)
    if code is not None:
        mod = code.co_filename.rsplit("/", 1)[-1].removesuffix(".py")
    else:
        mod = (getattr(target, "__module__", None) or "?").rsplit(
            ".", 1)[-1]
    qual = (getattr(target, "__qualname__", None)
            or getattr(target, "__name__", None) or repr(target))
    return f"{mod}.{qual}"


class ThreadRegistry:
    """Tracks daemon threads spawned on behalf of one owner (a raylet
    or GCS instance). Thread-safe; dead threads are pruned on spawn so
    recurring short-lived workers (retry sweeps) don't accumulate."""

    def __init__(self, owner: str):
        self.owner = owner
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        # thread name -> root-function label (see root_label): the one
        # source of truth tying a live thread back to the code root
        # that raycheck RC16/RC17 and perf_dump lanes report against
        self._roots: Dict[str, str] = {}

    def spawn(self, target: Callable, name: str,
              args: Tuple = ()) -> threading.Thread:
        """Create, register, and start a named daemon thread."""
        t = threading.Thread(target=target, args=args, daemon=True,
                             name=name)
        with self._lock:
            alive = [x for x in self._threads if x.is_alive()]
            for x in self._threads:
                if not x.is_alive():
                    self._roots.pop(x.name, None)
            self._threads = alive
            self._threads.append(t)
            self._roots[name] = root_label(target)
        t.start()
        return t

    def alive(self) -> List[str]:
        with self._lock:
            return [t.name for t in self._threads if t.is_alive()]

    def roots(self) -> Dict[str, str]:
        """Live threads' ``{thread name: root-function label}`` — the
        root naming shared with raycheck's RC16/RC17 reports."""
        with self._lock:
            return {t.name: self._roots.get(t.name, "?")
                    for t in self._threads if t.is_alive()}

    def join_all(self, timeout: float = 5.0) -> List[str]:
        """Join every tracked thread within ``timeout`` total; returns
        (and WARN-logs) the names still running — a teardown flake
        surfaces as a *named* hung thread, not a leaked one."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        hung: List[str] = []
        for t in threads:
            if t is threading.current_thread():
                continue  # joining yourself deadlocks the teardown
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                hung.append(t.name)
        if hung:
            logger.warning(
                "%s teardown: %d thread(s) still running after %.1fs: "
                "%s", self.owner, len(hung), timeout, ", ".join(hung))
        return hung
