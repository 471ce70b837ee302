"""The port's serve resilience plane on the CPU: the contracts of
tests/test_serve_resilience.py — replica health probing, graceful
drains, overload-aware routing, and the seeded storm harness
(serve/{controller,replica,handle}.py + cluster/fault_plane.StormPlan)
— run on ``ray_tpu_torch.serve``, and parity with the JAX package: for
one seed, ``StormPlan``'s timeline, plan and kill events, and the P2C
router's sampled candidate pairs, are equal in both packages (exact:
both are pure functions of the seed).

The storm scenarios run under a FIXED seed; a failing storm prints its
replay recipe (seed + derived plan). Under a seeded storm at sustained
QPS, the plane ON yields ZERO wrong responses and goodput above the bar
while unhealthy replicas are detected, drained and replaced; the plane
OFF on the same seed observably returns wrong/failed responses. A calm
rolling update completes with zero dropped in-flight requests.
"""

import json
import sys
import threading
import time
from contextlib import contextmanager

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private.config import Config
from ray_tpu_torch.cluster import fault_plane, overload
from ray_tpu_torch.cluster.fault_plane import FaultPlane, StormPlan
from ray_tpu_torch.exceptions import BackpressureError, RetryLaterError
from ray_tpu_torch.serve.handle import _replica_key

pytestmark = pytest.mark.serve_resilience

STORM_SEED = 1234  # 2 replica kills + 2 corrupt bursts + a serve stall


def _metric_total(name: str) -> float:
    from ray_tpu_torch.observability.metrics import get_metric

    m = get_metric(name)
    return sum(m.series().values()) if m is not None else 0.0


@contextmanager
def storm_replay_guard(storm: StormPlan):
    """On any failure, print the exact recipe to re-run the storm."""
    try:
        yield
    except BaseException:
        print(f"\n[serve-storm] REPLAY: {storm.describe()}\n"
              f"[serve-storm] plan="
              f"{json.dumps(storm.plan())}\n"
              f"[serve-storm] kills={json.dumps(storm.kill_events())}",
              file=sys.stderr)
        raise


@pytest.fixture
def serve_instance():
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    try:
        serve.start()
        yield
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        fault_plane.clear_plane()
        overload.reset()


# ------------------------------------------------------------ storm harness


def test_storm_plan_same_seed_identical_timeline():
    """The replay contract: StormPlan is a pure function of (seed,
    duration, intensity, kinds) — derived twice, the burst windows and
    kill events are bit-for-bit identical."""
    a = StormPlan(STORM_SEED, duration_s=4.0, intensity=1.5)
    b = StormPlan(STORM_SEED, duration_s=4.0, intensity=1.5)
    assert a.timeline() == b.timeline()
    assert a.plan() == b.plan()
    assert a.kill_events() == b.kill_events()
    # and the seed matters: a neighboring seed derives a different storm
    c = StormPlan(STORM_SEED + 1, duration_s=4.0, intensity=1.5)
    assert a.timeline() != c.timeline()


@pytest.mark.parametrize("seed", [STORM_SEED, 7, 2024])
def test_storm_plan_equals_reference(seed):
    """The same seed derives the same storm in both packages: a storm
    printed by one replays in the other."""
    from ray_tpu.cluster.fault_plane import StormPlan as JaxStormPlan

    for kwargs in ({}, {"duration_s": 4.0, "intensity": 1.5}):
        ours, ref = StormPlan(seed, **kwargs), JaxStormPlan(seed, **kwargs)
        assert ours.timeline() == ref.timeline()
        assert ours.kill_events() == ref.kill_events()
        assert ours.plan() == ref.plan()


def test_router_p2c_pairs_equal_reference():
    """Under a fault plan the router draws its P2C pairs from
    ``derive_rng("serve-router|<deployment>")``: for the same plan seed
    and candidate list, both packages sample the same pairs and pick the
    same replicas."""
    from ray_tpu.cluster import fault_plane as jax_fault_plane
    from ray_tpu.serve.handle import Router as JaxRouter

    from ray_tpu_torch.serve.handle import Router

    candidates = [(f"serve::model::{i:016x}", f"replica-{i}")
                  for i in range(5)]
    inflight = {candidates[1][0]: 1, candidates[3][0]: 2}

    def draws(plane_mod, router_cls):
        plane_mod.install_plane(plane_mod.FaultPlane(
            {"seed": STORM_SEED, "rules": []}))
        try:
            router = router_cls(None, "model")
        finally:
            plane_mod.clear_plane()
        pairs, sample = [], router._rng.sample

        def recording_sample(population, k):
            pair = sample(population, k)
            pairs.append([key for key, _ in pair])
            return pair

        router._rng.sample = recording_sample
        picks = [router._pick_p2c(candidates, inflight)[1]
                 for _ in range(200)]
        return pairs, picks

    ours = draws(fault_plane, Router)
    ref = draws(jax_fault_plane, JaxRouter)
    assert len(ours[0]) == 200
    assert ours == ref


def test_storm_plan_composes_existing_rule_kinds():
    storm = StormPlan(STORM_SEED, duration_s=3.0)
    # every generated rule must already be a valid FaultPlane rule —
    # the storm composes EXISTING kinds, it does not invent new ones
    plane = FaultPlane(storm.plan())
    assert plane.seed == STORM_SEED
    actions = {r["action"] for r in storm.rules}
    assert actions <= {"stall", "drop", "corrupt", "partition"}
    assert "corrupt" in actions and "stall" in actions
    kills = storm.kill_events()
    assert kills == sorted(kills, key=lambda k: (k["t"], k["target"],
                                                 k["ordinal"]))
    assert {k["target"] for k in kills} <= {"replica", "raylet"}
    # windows sit inside the storm duration
    for r in storm.rules:
        assert 0.0 <= r["start_s"] < storm.duration_s
        assert r["stop_s"] is None or r["stop_s"] <= storm.duration_s + 1


def test_storm_seed_from_env_accepts_bare_int_and_plan(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FAULT_PLAN", "777")
    assert fault_plane.storm_seed_from_env() == 777
    monkeypatch.setenv("RAY_TPU_FAULT_PLAN",
                       json.dumps({"seed": 55, "rules": []}))
    assert fault_plane.storm_seed_from_env() == 55
    monkeypatch.delenv("RAY_TPU_FAULT_PLAN")
    assert fault_plane.storm_seed_from_env(9) == 9


def test_failing_storm_prints_replay_recipe(capsys):
    storm = StormPlan(STORM_SEED)
    with pytest.raises(AssertionError):
        with storm_replay_guard(storm):
            assert False, "synthetic storm failure"
    err = capsys.readouterr().err
    assert f"RAY_TPU_FAULT_PLAN='{STORM_SEED}'" in err
    assert "plan=" in err and "kills=" in err


# ---------------------------------------------------------- health probing


def test_unhealthy_replica_detected_drained_replaced(serve_instance):
    """A replica whose check_health goes false (wedged-but-alive, NOT
    actor death) is detected after threshold consecutive probes,
    removed from routing, and replaced by a fresh replica."""
    unhealthy_before = _metric_total("ray_tpu_serve_replicas_unhealthy")

    @serve.deployment(num_replicas=2, health_check_period_s=0.1,
                      health_check_timeout_s=1.0,
                      health_check_failure_threshold=2)
    class Sickly:
        def __init__(self):
            self.sick = False

        def poison(self):
            self.sick = True
            return True

        def check_health(self):
            return not self.sick

        def __call__(self):
            return "ok"

    Sickly.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("Sickly"))
    assert len(replicas) == 2
    victim = replicas[0]
    victim_id = victim._actor_id
    ray_tpu_torch.get(victim.handle_request.remote("poison", (), {}))

    deadline = time.monotonic() + 15.0
    replaced = False
    while time.monotonic() < deadline:
        _, now = ray_tpu_torch.get(controller.get_replicas.remote("Sickly"))
        ids = {r._actor_id for r in now}
        if victim_id not in ids and len(now) == 2:
            replaced = True
            break
        time.sleep(0.05)
    assert replaced, "unhealthy replica was never replaced"
    assert _metric_total("ray_tpu_serve_replicas_unhealthy") \
        >= unhealthy_before + 1
    # serving continues on the healthy set
    h = Sickly.get_handle()
    assert ray_tpu_torch.get([h.remote()])[0] == "ok"


def test_dead_replica_detected_and_replaced(serve_instance):
    """Outright actor death also fails the probe (the call raises) and
    the reconcile loop restores the target replica count."""

    @serve.deployment(num_replicas=2, health_check_period_s=0.1,
                      health_check_failure_threshold=2)
    def echo(x=None):
        return f"echo:{x}"

    echo.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("echo"))
    dead_id = replicas[0]._actor_id
    ray_tpu_torch.kill(replicas[0])

    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        _, now = ray_tpu_torch.get(controller.get_replicas.remote("echo"))
        ids = {r._actor_id for r in now}
        if dead_id not in ids and len(now) == 2:
            break
        time.sleep(0.05)
    _, now = ray_tpu_torch.get(controller.get_replicas.remote("echo"))
    assert dead_id not in {r._actor_id for r in now} and len(now) == 2
    h = echo.get_handle()
    assert ray_tpu_torch.get([h.remote("a")])[0] == "echo:a"


# ---------------------------------------------------------- graceful drains


def test_calm_rolling_update_drops_zero_inflight(serve_instance):
    """The acceptance bar: requests in flight on the OLD replicas when
    a rolling update lands all complete — routing moves to the new set
    first, the old set drains to zero in-flight, then dies."""
    drains_before = _metric_total("ray_tpu_serve_drains_completed")

    @serve.deployment(num_replicas=2, version="v1",
                      graceful_shutdown_timeout_s=10.0)
    class Slow:
        def __call__(self, x):
            time.sleep(0.3)
            return f"v:{x}"

    Slow.deploy()
    h = Slow.get_handle()
    refs = [h.remote(i) for i in range(8)]  # in flight on v1 replicas
    Slow.options(version="v2").deploy()     # rolling update NOW
    results = ray_tpu_torch.get(refs, timeout=30.0)
    assert results == [f"v:{i}" for i in range(8)]  # zero dropped
    assert _metric_total("ray_tpu_serve_drains_completed") \
        >= drains_before + 2  # both v1 replicas drained cleanly
    # and the new set serves
    assert ray_tpu_torch.get([h.remote("x")])[0] == "v:x"


def test_scale_down_drains_before_kill(serve_instance):
    drains_before = _metric_total("ray_tpu_serve_drains_completed")

    @serve.deployment(num_replicas=3, graceful_shutdown_timeout_s=10.0)
    class Busy:
        def __call__(self, x):
            time.sleep(0.25)
            return x * 2

    Busy.deploy()
    h = Busy.get_handle()
    refs = [h.remote(i) for i in range(9)]  # spread across 3 replicas
    Busy.options(num_replicas=1).deploy()   # scale down mid-flight
    assert sorted(ray_tpu_torch.get(refs, timeout=30.0)) == \
        sorted(i * 2 for i in range(9))
    assert _metric_total("ray_tpu_serve_drains_completed") \
        >= drains_before + 2
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, now = ray_tpu_torch.get(controller.get_replicas.remote("Busy"))
    assert len(now) == 1


def test_draining_replica_sheds_with_typed_hint(serve_instance):
    """Past its grace window a draining replica sheds new work with
    RetryLaterError (the typed hint the router's weight-down and the
    HTTP 503 mapping consume)."""

    @serve.deployment(num_replicas=1)
    def f(x=None):
        return x

    f.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("f"))
    replica = replicas[0]
    ray_tpu_torch.get(replica.drain.remote(0.0))  # no grace
    with pytest.raises(RetryLaterError):
        ray_tpu_torch.get(replica.handle_request.remote("__call__", (1,), {}))


# ------------------------------------------------- overload-aware routing


def test_router_excludes_open_breaker(serve_instance):
    """An open circuit breaker takes its replica out of the candidate
    set: every request lands on the other replica."""
    excluded_before = _metric_total("ray_tpu_serve_router_excluded")

    @serve.deployment(num_replicas=2)
    class Count:
        def __init__(self):
            self.n = 0

        def __call__(self):
            self.n += 1
            return self.n

    Count.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("Count"))
    shunned = _replica_key("Count", replicas[0])
    breaker = overload.breaker_for(shunned)
    for _ in range(breaker.threshold):
        breaker.record_failure()
    assert breaker.state() == "open"

    h = Count.get_handle()
    ray_tpu_torch.get([h.remote() for _ in range(6)])
    totals = [ray_tpu_torch.get(r.metrics.remote())["total"] for r in replicas]
    assert totals[0] == 0 and totals[1] == 6
    assert _metric_total("ray_tpu_serve_router_excluded") \
        > excluded_before


def test_router_weighs_down_shed_penalized_replica(serve_instance):
    """A fresh RetryLaterError shed hint temporarily excludes the
    replica (weight-down) instead of blind re-offering; after the hint
    expires it rejoins the rotation."""

    @serve.deployment(num_replicas=2)
    def g(x=None):
        return x

    g.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("g"))
    penalized = _replica_key("g", replicas[0])
    overload.note_shed(penalized, 0.5)

    h = g.get_handle()
    ray_tpu_torch.get([h.remote(i) for i in range(6)])
    totals = [ray_tpu_torch.get(r.metrics.remote())["total"] for r in replicas]
    assert totals[0] == 0 and totals[1] == 6
    time.sleep(0.6)  # penalty expired -> replica rejoins
    ray_tpu_torch.get([h.remote(i) for i in range(4)])
    totals = [ray_tpu_torch.get(r.metrics.remote())["total"] for r in replicas]
    assert totals[0] > 0


def test_backpressure_error_when_all_replicas_shedding(serve_instance):
    """Every replica penalized + retry budget dry => handle.remote()
    surfaces the typed BackpressureError with a retry hint instead of
    queueing blind work."""
    bp_before = _metric_total("ray_tpu_serve_requests_backpressured")

    @serve.deployment(num_replicas=2)
    def h_fn(x=None):
        return x

    h_fn.deploy()
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas = ray_tpu_torch.get(controller.get_replicas.remote("h_fn"))
    for r in replicas:
        overload.note_shed(_replica_key("h_fn", r), 30.0)
    budget = overload.budget_for("serve::h_fn")
    while budget.try_spend():  # drain the desperation budget
        pass

    cfg = Config.instance()
    old = cfg.serve_router_backpressure_timeout_s
    cfg.serve_router_backpressure_timeout_s = 0.3
    try:
        h = h_fn.get_handle()
        t0 = time.monotonic()
        with pytest.raises(BackpressureError) as ei:
            h.remote(1)
        assert time.monotonic() - t0 < 5.0
        assert ei.value.retry_after_s > 0
        assert ei.value.deployment == "h_fn"
    finally:
        cfg.serve_router_backpressure_timeout_s = old
    assert _metric_total("ray_tpu_serve_requests_backpressured") \
        >= bp_before + 1


def test_p2c_prefers_less_loaded_replica(serve_instance):
    """Power-of-two-choices: with one replica wedged on a slow call,
    subsequent requests pile onto the idle one instead of alternating
    blindly."""
    ev = threading.Event()

    @serve.deployment(num_replicas=2)
    class MaybeSlow:
        def __call__(self, block=False):
            if block:
                time.sleep(1.0)
            return "done"

    MaybeSlow.deploy()
    h = MaybeSlow.get_handle()
    ray_tpu_torch.get([h.remote()])  # warm membership
    slow_ref = h.remote(True)  # occupies one replica for ~1s
    time.sleep(0.05)
    fast = [h.remote() for _ in range(6)]
    t0 = time.monotonic()
    assert ray_tpu_torch.get(fast, timeout=10.0) == ["done"] * 6
    # the fast requests never queued behind the blocked replica
    assert time.monotonic() - t0 < 0.9
    ray_tpu_torch.get([slow_ref])
    ev.set()


# ------------------------------------------------ reply-seam corruption


def test_reply_corruption_caught_with_plane_on_wrong_with_plane_off(
        serve_instance):
    """The replica's checksummed response seam: a seeded corrupt burst
    flips a byte of the serialized reply. Plane ON, the crc catches it
    and the intact value is re-served (zero wrong answers, detections
    counted); plane OFF on the SAME seed, wrongness flows to callers."""
    detected_before = _metric_total(
        "ray_tpu_objects_corruption_detected")

    @serve.deployment(num_replicas=1)
    def triple(x=0):
        return "pad" * 40 + f"|{x * 3}"

    triple.deploy()
    h = triple.get_handle()
    expected = lambda x: "pad" * 40 + f"|{x * 3}"  # noqa: E731

    plan = {"seed": STORM_SEED, "rules": [
        {"action": "corrupt", "direction": "reply",
         "dst": "serve::*", "method": "*", "prob": 1.0}]}
    fault_plane.install_plane(FaultPlane(plan))
    try:
        # plane ON: every reply corrupted in transit, every one caught
        for i in range(10):
            assert ray_tpu_torch.get([h.remote(i)])[0] == expected(i)
        assert _metric_total("ray_tpu_objects_corruption_detected") \
            >= detected_before + 10

        # plane OFF, same seed: silent wrongness (or a loud unpickle
        # error when the flip lands in pickle structure) reaches callers
        cfg = Config.instance()
        cfg.serve_resilience_enabled = False
        try:
            bad = 0
            for i in range(10):
                try:
                    if ray_tpu_torch.get([h.remote(i)])[0] != expected(i):
                        bad += 1
                except Exception:
                    bad += 1
            assert bad > 0, (
                "plane off never produced an observably wrong/failed "
                "reply under the corrupt burst")
        finally:
            cfg.serve_resilience_enabled = True
    finally:
        fault_plane.clear_plane()


# ------------------------------------------------------- the storm demo


def _open_loop(handle, expected_fn, qps: float, duration_s: float):
    """Open-loop driver: issue at the schedule regardless of
    completions; classify each reply as correct / wrong / failed."""
    sent = []
    t0 = time.monotonic()
    i = 0
    while time.monotonic() - t0 < duration_s:
        target = t0 + i / qps
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            sent.append((i, handle.remote(i)))
        except Exception:
            sent.append((i, None))  # backpressured / no replicas
        i += 1
    correct = wrong = failed = 0
    for i, ref in sent:
        if ref is None:
            failed += 1
            continue
        try:
            value = ray_tpu_torch.get(ref, timeout=15.0)
        except Exception:
            failed += 1
            continue
        if value == expected_fn(i):
            correct += 1
        else:
            wrong += 1
    return correct, wrong, failed, len(sent)


def _kill_driver(storm: StormPlan, deployment: str,
                 stop: threading.Event) -> threading.Thread:
    def run():
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        t0 = time.monotonic()
        for ev in storm.kill_events():
            if ev["target"] != "replica":
                continue  # raylet kills apply to process-tier storms
            delay = ev["t"] - (time.monotonic() - t0)
            if delay > 0 and stop.wait(delay):
                return
            try:
                _, replicas = ray_tpu_torch.get(
                    controller.get_replicas.remote(deployment))
                if replicas:
                    victim = replicas[ev["ordinal"] % len(replicas)]
                    ray_tpu_torch.kill(victim)
            except Exception as e:
                print(f"[serve-storm] kill event {ev} failed: {e!r}",
                      file=sys.stderr)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_storm_smoke_plane_on_zero_wrong_bounded_goodput(serve_instance):
    """THE acceptance demo: a seeded storm (replica kills + stalls +
    reply-corrupt bursts from one RAY_TPU_FAULT_PLAN seed) at sustained
    QPS. Plane ON: zero wrong responses, goodput >= 70%, unhealthy
    replicas detected and replaced. Plane OFF, same seed: wrong/failed
    responses observably reach callers."""
    seed = fault_plane.storm_seed_from_env(STORM_SEED)
    storm = StormPlan(seed, duration_s=3.0)
    unhealthy_before = _metric_total("ray_tpu_serve_replicas_unhealthy")

    @serve.deployment(num_replicas=3, max_concurrent_queries=16,
                      health_check_period_s=0.1,
                      health_check_timeout_s=1.0,
                      health_check_failure_threshold=2,
                      graceful_shutdown_timeout_s=2.0)
    def model(x=0):
        return "w" * 64 + f"|{x * 31 + 7}"

    expected = lambda x: "w" * 64 + f"|{x * 31 + 7}"  # noqa: E731
    model.deploy()
    h = model.get_handle()
    ray_tpu_torch.get([h.remote(0)])  # warm

    with storm_replay_guard(storm):
        fault_plane.install_plane(FaultPlane(storm.plan()))
        stop = threading.Event()
        killer = _kill_driver(storm, "model", stop)
        try:
            correct, wrong, failed, total = _open_loop(
                h, expected, qps=60.0, duration_s=storm.duration_s)
        finally:
            stop.set()
            killer.join(timeout=5.0)
            fault_plane.clear_plane()

        assert wrong == 0, f"{wrong} WRONG responses under storm"
        goodput = correct / max(total, 1)
        assert goodput >= 0.70, (
            f"goodput {goodput:.1%} under storm "
            f"(correct={correct} failed={failed} total={total})")
        # the killed replicas were detected and replaced
        assert _metric_total("ray_tpu_serve_replicas_unhealthy") \
            > unhealthy_before
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            _, now = ray_tpu_torch.get(controller.get_replicas.remote("model"))
            if len(now) == 3:
                break
            time.sleep(0.1)
        assert len(now) == 3, "replica set never recovered to target"

        # plane OFF, same seed: the same storm visibly hurts
        cfg = Config.instance()
        cfg.serve_resilience_enabled = False
        try:
            fault_plane.install_plane(FaultPlane(storm.plan()))
            stop2 = threading.Event()
            killer2 = _kill_driver(storm, "model", stop2)
            try:
                c2, w2, f2, t2 = _open_loop(
                    h, expected, qps=40.0, duration_s=2.0)
            finally:
                stop2.set()
                killer2.join(timeout=5.0)
                fault_plane.clear_plane()
            assert w2 + f2 > 0, (
                "plane off under the same storm never dropped, failed, "
                "or corrupted a response")
        finally:
            cfg.serve_resilience_enabled = True


# ----------------------------------------------------- counters surfacing


def test_serve_counters_ride_heartbeat_schema():
    """The heartbeat message carries the optional serve counter dict
    (evolution posture: old senders omit it, the GCS keeps {}), and the
    raylet's _serve_stats snapshot has the pinned key set."""
    from dataclasses import fields

    from ray_tpu_torch.cluster import schema
    from ray_tpu_torch.cluster.raylet_server import RayletServer

    hb = {f.name: f for f in fields(schema.schema_for("heartbeat"))}
    assert "serve" in hb and hb["serve"].default is None
    out = schema.validate("heartbeat", {
        "node_id": "n1", "available": {}, "resources": {},
        "serve": {"replicas_unhealthy": 1}})
    assert out["serve"] == {"replicas_unhealthy": 1}
    # an old sender omitting it still validates
    out = schema.validate("heartbeat", {
        "node_id": "n1", "available": {}, "resources": {}})
    assert out["serve"] is None

    stats = RayletServer._serve_stats(None)
    assert set(stats) == {"replicas_unhealthy", "drains_completed",
                          "router_excluded", "requests_backpressured"}
