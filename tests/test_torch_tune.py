"""The port's ray_tpu_torch.tune against the JAX package's ray_tpu.tune,
on the CPU: the 17 scenarios of tests/test_tune.py on both packages.

- Variants: the same spec and seed give equal (tag, config) lists.
- Schedulers: one synthetic result stream, drawn from a seed, goes
  through a fake runner (the scheduler-facing surface of TrialRunner) on
  each side; the decision logs, PBT/PB2's explored configs among them,
  must be equal. Unlike a live tune.run, this does not depend on the
  order in which trials' results arrive.
- End to end: each scenario runs through tune.run on both runtimes (the
  port's on ``init(device="cpu")``), one after the other; the result
  sets must be equal (not their order, which follows thread timing).
- The stopped-trial repair: a function trial stopped by ASHA runs its
  finally blocks and its thread ends within 10 s of the stop (the JAX
  package leaves that thread blocked in tune.report for good).
"""

import contextlib
import math
import random
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune

SIDES = ((ray_tpu, jtune), (ray_tpu_torch, ttune))


@contextlib.contextmanager
def _runtime(core, num_cpus: int = 4):
    if core is ray_tpu_torch:
        core.init(num_cpus=num_cpus, device="cpu")
    else:
        core.init(num_cpus=num_cpus)
    try:
        yield
    finally:
        core.shutdown()


def _on_both(scenario, num_cpus: int = 4):
    """``scenario(tune)`` on the JAX runtime, then on the port's ->
    (JAX result, port result)."""
    out = []
    for core, tune in SIDES:
        with _runtime(core, num_cpus):
            out.append(scenario(tune))
    return tuple(out)


# ------------------------------------------------------------------ variants


def _variants(tune, spec, seed):
    from importlib import import_module

    vg = import_module(f"{tune.__name__}.variant_generator")
    random.seed(seed)  # tune.randn draws from the global random
    return list(vg.generate_variants(spec, random.Random(seed))), \
        vg.count_variants(spec)


class TestVariantGenerator:
    def test_grid_cross_product(self):
        def spec(tune):
            return {"a": tune.grid_search([1, 2]),
                    "b": tune.grid_search(["x", "y"]), "c": 5}

        (want, nw), (got, ng) = (_variants(t, spec(t), 0) for _, t in SIDES)
        assert got == want and ng == nw == 4
        assert {(c["a"], c["b"]) for _, c in got} == \
            {(1, "x"), (1, "y"), (2, "x"), (2, "y")}
        assert all(c["c"] == 5 for _, c in got)

    def test_nested_and_sampled(self):
        def spec(tune):
            return {"opt": {"lr": tune.uniform(0.1, 0.2),
                            "m": tune.grid_search([0.9, 0.99])},
                    "w": tune.loguniform(1e-4, 1e-1),
                    "q": tune.quniform(0.0, 1.0, 0.25)}

        (want, _), (got, _) = (_variants(t, spec(t), 3) for _, t in SIDES)
        assert got == want and len(got) == 2
        for _, v in got:
            assert 0.1 <= v["opt"]["lr"] <= 0.2
        assert {v["opt"]["m"] for _, v in got} == {0.9, 0.99}

    def test_choice_randint(self):
        def spec(tune):
            return {"a": tune.choice([1, 2, 3]), "b": tune.randint(0, 10),
                    "c": tune.qrandint(0, 100, 5), "n": tune.randn(0, 1),
                    "f": tune.sample_from(lambda _: 7)}

        for seed in range(4):
            (want, _), (got, _) = (_variants(t, spec(t), seed)
                                   for _, t in SIDES)
            assert got == want
            [(_, v)] = got
            assert v["a"] in (1, 2, 3) and 0 <= v["b"] < 10
            assert v["c"] % 5 == 0 and v["f"] == 7


# ---------------------------------------------------------------- schedulers


class _FakeRunner:
    """What a scheduler sees of TrialRunner: its trials, resources,
    completion (which, as TrialRunner's, tells the scheduler), and PBT's
    save/restart hooks, logged instead of run on actors."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self.trials = []
        self.log = []

    def add_trial(self, trial) -> None:
        self.trials.append(trial)
        self.scheduler.on_trial_add(self, trial)

    def has_resources_for(self, trial) -> bool:
        return True

    def _complete_trial(self, trial, result) -> None:
        trial.status = "TERMINATED"
        self.log.append(("complete", trial.trial_id))
        self.scheduler.on_trial_complete(self, trial, result)

    def save_trial(self, trial):
        return {"from": trial.trial_id, "iteration": len(trial.results)}

    def restart_trial_with(self, trial, new_config, checkpoint) -> None:
        trial.config = new_config
        self.log.append(("restart", trial.trial_id, dict(new_config),
                         dict(checkpoint)))


def _score(config, it: int) -> float:
    return config["rate"] * math.log1p(it) + 0.01 * config["offset"]


def _drive(tune, make_scheduler, rates, seed: int = 0, max_iter: int = 12,
           events: int = 200):
    """Feed the scheduler ``events`` results, each from a running trial
    that random.Random(seed) picks, as TrialRunner.step would (the stop
    criterion at ``max_iter`` first, then the scheduler's decision) ->
    (the runner's log, the scheduler)."""
    sched = make_scheduler(tune)
    runner = _FakeRunner(sched)
    for i, rate in enumerate(rates):
        trial = tune.Trial(trainable_cls=object,
                           config={"rate": rate, "offset": i},
                           experiment_tag=str(i))
        trial.trial_id = f"t{i}"
        runner.add_trial(trial)
    rng = random.Random(seed)
    for _ in range(events):
        while (t := sched.choose_trial_to_run(runner)) is not None:
            t.status = "RUNNING"
            runner.log.append(("start", t.trial_id))
        running = [t for t in runner.trials if t.status == "RUNNING"]
        if not running:
            break
        trial = rng.choice(running)
        it = len(trial.results) + 1
        result = {"training_iteration": it,
                  "score": _score(trial.config, it)}
        trial.update_result(result)
        if it >= max_iter:
            runner._complete_trial(trial, result)
            continue
        decision = sched.on_trial_result(runner, trial, result)
        runner.log.append(("result", trial.trial_id, it, decision))
        if decision == "STOP":
            runner._complete_trial(trial, result)
        elif decision == "PAUSE":
            trial.status = "PAUSED"
    return runner.log, sched


SCHEDULERS = {
    "asha": (lambda tune: tune.AsyncHyperBandScheduler(
        metric="score", mode="max", max_t=12, grace_period=2,
        reduction_factor=2), [1, 2, 3, 4, 5, 6, 7, 8]),
    "hyperband": (lambda tune: tune.HyperBandScheduler(
        metric="score", mode="max", max_t=9, reduction_factor=3),
        [1, 2, 3, 4, 5, 6]),
    "median": (lambda tune: tune.MedianStoppingRule(
        metric="score", mode="max", grace_period=2,
        min_samples_required=2), [1, 1, 10, 2, 3]),
    "pbt": (lambda tune: tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"rate": [1, 2, 4, 8]}, seed=0),
        [1, 8, 2, 4]),
    "pb2": (lambda tune: tune.PB2(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_bounds={"rate": (1.0, 8.0)}, seed=7),
        [1.0, 2.5, 6.0, 8.0]),
    "bohb": (lambda tune: tune.HyperBandForBOHB(
        metric="score", mode="max", max_t=9, reduction_factor=3),
        [3, 1, 4, 1, 5, 9, 2, 6]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decisions_match_jax(name, seed):
    """ASHA, HyperBand, MedianStopping, PBT (seeded), PB2 (seeded) and
    HyperBandForBOHB: the same result stream gives the same decisions,
    completions and explored configs on both packages."""
    make, rates = SCHEDULERS[name]
    (want, jsched), (got, tsched) = (_drive(t, make, rates, seed)
                                     for _, t in SIDES)
    assert got == want
    decisions = {e[3] for e in got if e[0] == "result"}
    if name in ("pbt", "pb2"):
        assert tsched.num_perturbations == jsched.num_perturbations >= 1
        assert any(e[0] == "restart" for e in got)
    else:
        assert "STOP" in decisions
    if name in ("hyperband", "bohb"):
        assert "PAUSE" in decisions
    if name == "pb2":
        assert all(1.0 <= e[2]["rate"] <= 8.0 for e in got
                   if e[0] == "restart")


# ----------------------------------------------------------------- end to end


def _my_trainable(tune):
    class MyTrainable(tune.Trainable):
        def setup(self, config):
            self.x = config.get("start", 0)
            self.rate = config.get("rate", 1)

        def step(self):
            self.x += self.rate
            return {"score": self.x}

        def save_checkpoint(self, checkpoint_dir=""):
            return {"x": self.x}

        def load_checkpoint(self, checkpoint):
            self.x = checkpoint["x"]

        def reset_config(self, new_config):
            self.rate = new_config.get("rate", 1)
            return True

    return MyTrainable


def _last(analysis, *keys):
    return sorted(tuple(t.last_result.get(k) for k in keys)
                  for t in analysis.trials)


class TestTuneRun:
    def test_class_trainable_grid(self):
        def scenario(tune):
            a = tune.run(_my_trainable(tune),
                         config={"rate": tune.grid_search([1, 2, 3])},
                         stop={"training_iteration": 4},
                         metric="score", mode="max")
            return (sorted((t.config["rate"], t.last_result["score"])
                           for t in a.trials),
                    a.best_config["rate"], a.best_result["score"])

        want, got = _on_both(scenario)
        assert got == want == ([(1, 4), (2, 8), (3, 12)], 3, 12)

    def test_function_trainable(self):
        def scenario(tune):
            def train_fn(config):
                acc = 0.0
                for i in range(5):
                    acc += config["lr"]
                    tune.report(mean_accuracy=acc, training_iteration=i + 1)

            a = tune.run(train_fn,
                         config={"lr": tune.grid_search([0.1, 0.5])},
                         metric="mean_accuracy", mode="max")
            return (sorted((t.config["lr"], tuple(
                r["mean_accuracy"] for r in t.results)) for t in a.trials),
                a.best_config["lr"])

        want, got = _on_both(scenario)
        assert got == want and got[1] == 0.5
        assert got[0][1][1][-1] == pytest.approx(2.5)

    def test_num_samples(self):
        def scenario(tune):
            random.seed(0)
            a = tune.run(_my_trainable(tune),
                         config={"rate": tune.choice([1]),
                                 "start": tune.randint(0, 100)},
                         num_samples=3, stop={"training_iteration": 1},
                         metric="score", mode="max", seed=5)
            return sorted((t.config["start"], t.last_result["score"])
                          for t in a.trials)

        want, got = _on_both(scenario)
        assert got == want and len(got) == 3

    def test_trial_failure_retry(self):
        def scenario(tune):
            class Flaky(tune.Trainable):
                failed = False

                def setup(self, config):
                    self.i = 0

                def step(self):
                    self.i += 1
                    if self.i == 2 and not Flaky.failed:
                        Flaky.failed = True
                        raise RuntimeError("boom")
                    return {"score": self.i}

            a = tune.run(Flaky, config={}, stop={"training_iteration": 3},
                         max_failures=1, metric="score", mode="max")
            return [(t.status, t.num_failures, t.last_result["score"])
                    for t in a.trials]

        want, got = _on_both(scenario)
        assert got == want == [("TERMINATED", 1, 3)]

    def test_with_parameters(self):
        data = np.arange(100)

        def scenario(tune):
            def train_fn(config, data=None):
                tune.report(total=float(data.sum()) * config["f"])

            a = tune.run(tune.with_parameters(train_fn, data=data),
                         config={"f": tune.grid_search([1.0, 2.0])},
                         metric="total", mode="max")
            return _last(a, "total"), a.best_result["total"]

        want, got = _on_both(scenario)
        assert got == want and got[1] == float(data.sum()) * 2

    def test_checkpoint_dir_function_api(self):
        import os

        def scenario(tune):
            def train_fn(config, checkpoint_dir=None):
                start = 0
                if checkpoint_dir:
                    with open(os.path.join(checkpoint_dir, "s")) as f:
                        start = int(f.read())
                for i in range(start, 3):
                    with tune.checkpoint_dir(step=i) as d:
                        with open(os.path.join(d, "s"), "w") as f:
                            f.write(str(i))
                    tune.report(iter=i, training_iteration=i + 1)

            a = tune.run(train_fn, config={}, metric="iter", mode="max")
            [t] = a.trials
            return [r["iter"] for r in t.results], a.best_result["iter"]

        want, got = _on_both(scenario)
        assert got == want == ([0, 1, 2, 2], 2)  # the last repeats, done


def test_experiment_checkpoint_and_resume(tmp_path):
    """tune.run persists experiment state; resume=True re-runs nothing
    that finished and keeps its results, on both packages alike."""
    import os

    def scenario(tune):
        side = tmp_path / tune.__name__
        calls = []

        def train_fn(config):
            calls.append(config["x"])
            tune.report(score=config["x"] * 2)

        a1 = tune.run(train_fn, config={"x": tune.grid_search([1, 2, 3])},
                      metric="score", mode="max", name="resume-exp",
                      local_dir=str(side))
        first = sorted(calls)
        saved = os.path.exists(side / "resume-exp" / "experiment_state.pkl")
        calls.clear()
        a2 = tune.run(train_fn, config={"x": tune.grid_search([1, 2, 3])},
                      metric="score", mode="max", name="resume-exp",
                      local_dir=str(side), resume=True)
        return (first, saved, a1.best_result["score"], calls,
                a2.best_result["score"], _last(a2, "score"))

    want, got = _on_both(scenario, num_cpus=8)
    assert got == want == ([1, 2, 3], True, 6, [], 6, [(2,), (4,), (6,)])


def test_sync_config_mirrors_experiment_dir(tmp_path):
    import os

    def scenario(tune):
        side = tmp_path / tune.__name__

        def train_fn(config):
            tune.report(score=1)

        tune.run(train_fn, config={}, metric="score", mode="max",
                 name="sync-exp", local_dir=str(side / "local"),
                 sync_config={"upload_dir": str(side / "bucket")})
        return sorted(os.listdir(side / "bucket"))

    want, got = _on_both(scenario, num_cpus=8)
    assert got == want == ["experiment_state.pkl"]


def test_default_results_dir_is_the_ports_own(monkeypatch, tmp_path):
    """The port keeps its experiment state apart from the JAX package's:
    its default directory is ~/ray_tpu_torch_results, and
    RAY_TPU_RESULTS_DIR overrides both."""
    import os

    from ray_tpu.tune import syncer as jsyncer
    from ray_tpu_torch.tune import syncer as tsyncer

    monkeypatch.delenv("RAY_TPU_RESULTS_DIR", raising=False)
    home = os.path.expanduser("~")
    assert tsyncer.default_local_dir() == os.path.join(
        home, "ray_tpu_torch_results")
    assert jsyncer.default_local_dir() != tsyncer.default_local_dir()
    monkeypatch.setenv("RAY_TPU_RESULTS_DIR", str(tmp_path))
    assert tsyncer.default_local_dir() == str(tmp_path)


# The schedulers' end-to-end scenarios whose outcome does not hang on the
# order of results (ASHA's and PBT's are held by the fake-runner parity
# above), on the port, with the reference's assertions.


@pytest.fixture
def port_rt():
    with _runtime(ray_tpu_torch, num_cpus=4):
        yield


def test_hyperband_brackets_halve(port_rt):
    sched = ttune.HyperBandScheduler(
        time_attr="training_iteration", metric="score", mode="max",
        max_t=9, reduction_factor=3)
    analysis = ttune.run(
        _my_trainable(ttune),
        config={"rate": ttune.grid_search([1, 2, 3, 4, 5, 6])},
        scheduler=sched, stop={"training_iteration": 9})
    iters = sorted(t.last_result["training_iteration"]
                   for t in analysis.trials)
    assert iters[0] < 9 and iters[-1] == 9
    best = max(analysis.trials, key=lambda t: t.last_result.get("score", -1))
    assert best.config["rate"] == 6


def test_median_stopping(port_rt):
    sched = ttune.MedianStoppingRule(metric="score", mode="max",
                                     grace_period=2, min_samples_required=2)
    analysis = ttune.run(
        _my_trainable(ttune),
        config={"rate": ttune.grid_search([1, 1, 10])},
        scheduler=sched, stop={"training_iteration": 10})
    by_rate = {t.config["rate"]: t for t in analysis.trials}
    assert by_rate[10].last_result["training_iteration"] == 10


def test_pb2_explores_within_bounds():
    """PB2's explore step proposes values inside hyperparam_bounds, on
    both packages (the decisions themselves: the fake-runner parity)."""
    def scenario(tune):
        sched = tune.PB2(time_attr="training_iteration", metric="score",
                         mode="max", perturbation_interval=2,
                         hyperparam_bounds={"lr": (0.001, 0.1)}, seed=7)

        def train_fn(config):
            for i in range(8):
                tune.report(score=config["lr"] * (i + 1),
                            training_iteration=i + 1)

        analysis = tune.run(
            train_fn, config={"lr": tune.uniform(0.001, 0.1)},
            num_samples=4, metric="score", mode="max", scheduler=sched)
        return [t.config["lr"] for t in analysis.trials]

    for lrs in _on_both(scenario, num_cpus=8):
        assert len(lrs) == 4 and all(0.001 <= lr <= 0.1 for lr in lrs)


def test_bohb_scheduler_and_searcher(port_rt):
    from ray_tpu_torch.tune.suggest.bohb import BOHBSearcher

    def train_fn(config):
        for i in range(9):
            ttune.report(score=-(config["x"] - 0.7) ** 2,
                         training_iteration=i + 1)

    searcher = BOHBSearcher(metric="score", mode="max",
                            n_initial_points=3, seed=3)
    sched = ttune.HyperBandForBOHB(time_attr="training_iteration",
                                   metric="score", mode="max", max_t=9,
                                   reduction_factor=3)
    analysis = ttune.run(
        train_fn, config={"x": ttune.uniform(0.0, 1.0)},
        num_samples=12, metric="score", mode="max",
        scheduler=sched, search_alg=searcher)
    assert analysis.best_result["score"] > -0.2
    assert searcher._buckets


# -------------------------------------------------------------- the repair


class _TimedASHA(ttune.AsyncHyperBandScheduler):
    """ASHA that notes when each trial was completed."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.completed_at = {}

    def on_trial_complete(self, runner, trial, result):
        self.completed_at[trial.config["x"]] = time.monotonic()


def test_stopped_function_trial_runs_finally_and_ends(port_rt):
    """ASHA stops every trial while its function still has reports to
    make: the best at max_t, the rest trailing at rung 2 (one trial at a
    time, best first, so the stops are fixed). Each stopped function's
    finally runs, and its thread ends, within 10 s of the stop; after
    tune.run no trial function thread is alive."""
    finished = {}

    def train_fn(config):
        try:
            for i in range(1, 20):
                ttune.report(score=config["x"] * i, training_iteration=i)
        finally:
            finished[config["x"]] = (time.monotonic(),
                                     threading.current_thread().name)

    sched = _TimedASHA(metric="score", mode="max", max_t=8, grace_period=2,
                       reduction_factor=2)
    analysis = ttune.run(train_fn, config={"x": ttune.grid_search(
        [4, 3, 2, 1])}, scheduler=sched, max_concurrent_trials=1)
    iters = {t.config["x"]: len(t.results) for t in analysis.trials}
    assert iters == {4: 8, 3: 2, 2: 2, 1: 2}
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    assert sorted(finished) == [1, 2, 3, 4]
    for x, (t_end, name) in finished.items():
        assert name.startswith("tune-fn-")
        assert 0 <= t_end - sched.completed_at[x] < 10.0, x
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and any(
            th.name.startswith("tune-fn-") for th in threading.enumerate()):
        time.sleep(0.05)
    assert not [th.name for th in threading.enumerate()
                if th.name.startswith("tune-fn-")]


def test_stopped_function_trial_exits_past_except_exception(port_rt):
    """The stop unwinds a function that catches Exception around its
    reports: TrialStopped is a SystemExit, as upstream Ray's exit."""
    caught = []

    def train_fn(config):
        for i in range(1, 9):
            try:
                ttune.report(score=config["x"] * i, training_iteration=i)
            except Exception as e:  # noqa: BLE001
                caught.append(e)

    sched = ttune.AsyncHyperBandScheduler(metric="score", mode="max",
                                          max_t=8, grace_period=2,
                                          reduction_factor=2)
    analysis = ttune.run(train_fn, config={"x": ttune.grid_search([2, 1])},
                         scheduler=sched, max_concurrent_trials=1)
    assert sorted(len(t.results) for t in analysis.trials) == [2, 8]
    assert not caught
