"""Overload-robustness primitives: retry budgets and circuit breakers.

The fault plane (cluster/fault_plane.py) proves the cluster survives
drops, delays, and partitions; this module is the matching defense
against *load*. The failure shape it targets is the metastable retry
storm (Bronson et al., HotOS '21): a single stalled server turns N
healthy clients into an amplifying loop — every timeout or shed reply
becomes a retry, retries deepen the overload, and the system stays
wedged after the original trigger clears. The two client-side
mechanisms here, combined with server-side admission control in
cluster/rpc.py, bound that loop:

- :class:`RetryBudget` — a per-destination token bucket. Every retry
  spends one token; every success earns ``fraction`` tokens (capped).
  Aggregate retry traffic is therefore capped at roughly
  ``fraction x goodput`` plus a fixed initial burst — the SRE
  retry-budget discipline (reference: gRPC retry throttling's
  token_ratio, Google SRE book ch. 22).
- :class:`CircuitBreaker` — open after K consecutive failures, allow a
  single half-open probe after a cool-down, close on probe success.
  The open window honors the server's ``RetryLaterError`` backoff hint
  so an overloaded server's pushback sets the pace of re-contact.

Both are process-wide singletons PER DESTINATION (``budget_for`` /
``breaker_for``): every ``ResilientRpcClient`` in a process talking to
the same address shares one budget and one breaker, so the cap holds
for the process's aggregate traffic, not per client object. All state
transitions are deterministic (no randomness) — under a fault plan the
only jitter in the retry path remains the seeded backoff stream, so
overload scenarios replay from the plan's single seed.

Counters surface through observability.metrics (the Prometheus path)
and through :func:`snapshot` (the ``node_stats`` / ``cluster_view`` /
``cli.py status`` path).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ray_tpu_torch.observability.metrics import (
    fastlane_breaker_transitions,
    rpc_breaker_transitions,
    rpc_retries_spent,
    rpc_retry_budget_exhausted,
)

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class RetryBudget:
    """Token bucket capping retries at a fraction of goodput.

    The first attempt of a call is always free — the budget governs
    RETRIES only. ``try_spend`` takes one token (False = budget
    exhausted: give up and surface the error instead of amplifying);
    ``on_success`` earns ``fraction`` tokens up to ``cap``."""

    def __init__(self, fraction: float, initial: float, cap: float):
        self.fraction = float(fraction)
        self.cap = float(cap)
        self._tokens = min(float(initial), self.cap)
        self._lock = threading.Lock()
        self.num_spent = 0
        self.num_exhausted = 0

    @property
    def enabled(self) -> bool:
        return self.fraction > 0.0

    def try_spend(self) -> bool:
        if not self.enabled:
            return True  # budget disabled: never the limiting factor
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.num_spent += 1
                rpc_retries_spent.inc()
                return True
            self.num_exhausted += 1
            rpc_retry_budget_exhausted.inc()
            return False

    def on_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.fraction)

    def snapshot(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 3),
                    "spent": self.num_spent,
                    "exhausted": self.num_exhausted}


class CircuitBreaker:
    """Per-destination breaker: closed -> open after ``threshold``
    consecutive failures; after ``reset_s`` (or the server's
    RetryLaterError hint, whichever is larger) one half-open probe is
    admitted; probe success closes, probe failure re-opens.

    ``allow()`` answers "may an attempt go to the wire right now";
    callers that cannot send report the remaining open window via
    ``remaining_s()`` and sleep it off instead of spinning."""

    def __init__(self, threshold: int, reset_s: float):
        self.threshold = int(threshold)
        self.reset_s = float(reset_s)
        self._lock = threading.Lock()
        self._state = _CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._probe_inflight = False
        self.num_opens = 0

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        if not self.enabled:
            return True
        with self._lock:
            if self._state == _CLOSED:
                return True
            now = time.monotonic()
            if self._state == _OPEN and now >= self._open_until:
                self._state = _HALF_OPEN
                self._probe_inflight = False
            if self._state == _HALF_OPEN:
                if self._probe_inflight:
                    return False  # one probe at a time
                self._probe_inflight = True
                return True
            return False

    def remaining_s(self) -> float:
        """Seconds until the next probe is admitted (0 when closed or
        already probing)."""
        with self._lock:
            if self._state != _OPEN:
                return 0.0
            return max(0.0, self._open_until - time.monotonic())

    def record_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._state = _CLOSED
            self._failures = 0
            self._probe_inflight = False

    def record_failure(self, hint_s: Optional[float] = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._failures += 1
            window = max(self.reset_s, hint_s or 0.0)
            if self._state == _HALF_OPEN:
                # the probe failed: straight back to open
                self._open(window)
            elif self._state == _CLOSED \
                    and self._failures >= self.threshold:
                self._open(window)
            elif self._state == _OPEN:
                # a late failure (e.g. a hint-carrying shed from a
                # racing thread) extends the window to the newest hint
                self._open_until = max(
                    self._open_until, time.monotonic() + window)

    def _open(self, window: float) -> None:
        # caller holds the lock
        self._state = _OPEN
        self._open_until = time.monotonic() + window
        self._probe_inflight = False
        self.num_opens += 1
        rpc_breaker_transitions.inc(tags={"to": "open"})

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._failures,
                    "opens": self.num_opens}


# --------------------------------------------------------------------------
# process-wide per-destination registries
# --------------------------------------------------------------------------

_lock = threading.Lock()
_budgets: Dict[str, RetryBudget] = {}
_breakers: Dict[str, CircuitBreaker] = {}


def enabled() -> bool:
    """Master switch (Config.overload_enabled): off restores the
    pre-overload-plane behavior everywhere the plane is woven in."""
    from ray_tpu_torch._private.config import Config

    return bool(Config.instance().overload_enabled)


def budget_for(address: str) -> RetryBudget:
    with _lock:
        b = _budgets.get(address)
        if b is None:
            from ray_tpu_torch._private.config import Config

            cfg = Config.instance()
            b = RetryBudget(cfg.rpc_retry_budget_fraction,
                            cfg.rpc_retry_budget_initial,
                            cfg.rpc_retry_budget_cap)
            _budgets[address] = b
        return b


def breaker_for(address: str) -> CircuitBreaker:
    with _lock:
        br = _breakers.get(address)
        if br is None:
            from ray_tpu_torch._private.config import Config

            cfg = Config.instance()
            br = CircuitBreaker(cfg.rpc_breaker_failure_threshold,
                                cfg.rpc_breaker_reset_s)
            _breakers[address] = br
        return br


_penalties: Dict[str, float] = {}  # destination -> monotonic expiry


def note_shed(address: str, hint_s: float) -> None:
    """Record a destination's RetryLaterError shed hint: callers that
    consult :func:`shed_penalty_remaining` weight the destination DOWN
    for ``hint_s`` (temporary exclusion while alternatives exist)
    instead of blindly retrying against a peer that just said "later".
    The serve router keys these by replica; the hint's pace is the
    overloaded peer's own pushback, exactly like the breaker's open
    window."""
    until = time.monotonic() + max(0.0, float(hint_s))
    with _lock:
        if until > _penalties.get(address, 0.0):
            _penalties[address] = until


def shed_penalty_remaining(address: str) -> float:
    """Seconds left on ``address``'s shed weight-down (0 = none)."""
    with _lock:
        until = _penalties.get(address)
        if until is None:
            return 0.0
        remaining = until - time.monotonic()
        if remaining <= 0.0:
            del _penalties[address]
            return 0.0
        return remaining


# --------------------------------------------------------------------------
# fast-lane degraded mode: per-LANE breakers over the master switches
# --------------------------------------------------------------------------

# The three rebuilt hot paths, keyed by the Config master switch each
# one hides behind. A lane breaker going open means "this lane keeps
# failing in lane-specific ways — run the safe pre-lane path until a
# half-open probe survives"; the master switch itself is never written,
# so operator intent (switch OFF) and degraded mode (switch ON, breaker
# open) stay distinguishable in the stats.
LANES = {
    "dispatch": "dispatch_fastlane_enabled",
    "data_plane": "data_plane_pipeline_enabled",
    "scheduler": "scheduler_pipeline_enabled",
}

_lane_breakers: Dict[str, CircuitBreaker] = {}


class _LaneBreaker(CircuitBreaker):
    """CircuitBreaker whose transitions are counted per lane on the
    fastlane counter (the rpc counter stays per-destination)."""

    def __init__(self, lane: str, threshold: int, reset_s: float):
        super().__init__(threshold, reset_s)
        self.lane = lane
        self._last_counted = _CLOSED

    def _open(self, window: float) -> None:
        super()._open(window)
        if self._last_counted != _OPEN:
            self._last_counted = _OPEN
            fastlane_breaker_transitions.inc(
                tags={"lane": self.lane, "to": "open"})

    def record_success(self) -> None:
        super().record_success()
        if self.enabled and self._last_counted == _OPEN:
            self._last_counted = _CLOSED
            fastlane_breaker_transitions.inc(
                tags={"lane": self.lane, "to": "closed"})


def lane_breaker(lane: str) -> CircuitBreaker:
    """The process-wide degraded-mode breaker for one fast lane."""
    if lane not in LANES:
        raise ValueError(f"unknown fast lane {lane!r}; "
                         f"choose from {sorted(LANES)}")
    with _lock:
        br = _lane_breakers.get(lane)
        if br is None:
            from ray_tpu_torch._private.config import Config

            cfg = Config.instance()
            threshold = (cfg.fastlane_breaker_threshold
                         if cfg.fastlane_breaker_enabled else 0)
            br = _LaneBreaker(lane, threshold,
                              cfg.fastlane_breaker_reset_s)
            _lane_breakers[lane] = br
        return br


def lane_enabled(lane: str) -> bool:
    """Effective state of a fast lane's master switch: the Config
    switch AND'd with the lane breaker. Reads at the switch sites go
    through here; an ``allow()`` that returns True while the breaker is
    half-open IS the probe — the very next lane attempt reports back
    through :func:`lane_ok` / :func:`lane_failed`."""
    from ray_tpu_torch._private.config import Config

    if not bool(getattr(Config.instance(), LANES[lane])):
        return False
    return lane_breaker(lane).allow()


def lane_ok(lane: str) -> None:
    """A lane-specific operation completed on the fast path."""
    lane_breaker(lane).record_success()


def lane_failed(lane: str) -> None:
    """A lane-specific failure (batch frame error, tree failover,
    fenced tick): K consecutive ones flip the lane to the safe path."""
    lane_breaker(lane).record_failure()


def snapshot() -> dict:
    """Per-destination budget/breaker states for the stats surfaces
    (node_stats -> heartbeat -> cluster_view -> `cli.py status`)."""
    with _lock:
        budgets = dict(_budgets)
        breakers = dict(_breakers)
        lanes = dict(_lane_breakers)
    return {
        "retry_budgets": {a: b.snapshot() for a, b in budgets.items()},
        "breakers": {a: br.snapshot() for a, br in breakers.items()},
        "lanes": {name: br.snapshot() for name, br in lanes.items()},
    }


def reset() -> None:
    """Forget every per-destination budget/breaker/penalty (tests)."""
    with _lock:
        _budgets.clear()
        _breakers.clear()
        _penalties.clear()
        _lane_breakers.clear()
