"""The port's ray_tpu_torch.tune.suggest against the JAX package's, on the
CPU: the 17 scenarios of tests/test_tune_suggest.py.

Each searcher (seeded random, TPE, BayesOpt, BOHB, the concurrency
limiter, the repeater, the variant generator and the ask/tell adapter)
is driven on both packages by one loop that asks for suggestions and
tells each result back in a fixed order; the suggestion sequences must be
equal (tolerance 0: the same Python and numpy code, the same seeds). The
scenarios that run tune.run end to end then run on the port's runtime
(``init(device="cpu")``) with the reference's assertions; where the
searcher does not learn from results, their configs equal the JAX
package's run.
"""

import random

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune

SIDES = ((ray_tpu, jtune), (ray_tpu_torch, ttune))


@pytest.fixture
def port_rt():
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


def _on_jax(scenario):
    ray_tpu.init(num_cpus=4)
    try:
        return scenario(jtune)
    finally:
        ray_tpu.shutdown()


def score_of(config):
    # max at x=3, value 10
    return 10 - (config["x"] - 3.0) ** 2


def objective_for(tune):
    def objective(config):
        tune.report(score=score_of(config))
    return objective


def space(tune):
    return {"x": tune.uniform(-10.0, 10.0)}


def _sequence(tune, make, spec, value_of, n, metric="score", mode="max",
              batch=1, budgets=(1,), seed=0):
    """Ask for up to ``n`` suggestions, ``batch`` at a time, then report
    each of the batch in order, at every budget of ``budgets`` as
    training_iteration, and complete it -> the suggestions (None and
    FINISHED included) in order."""
    random.seed(seed)  # tune.randn draws from the global random
    searcher = make(tune.suggest)
    searcher.set_search_properties(metric, mode, spec(tune))
    out, asked = [], 0
    while asked < n:
        live = []
        for _ in range(batch):
            tid = f"trial_{asked}"
            asked += 1
            cfg = searcher.suggest(tid)
            out.append(cfg)
            if isinstance(cfg, dict):
                live.append((tid, cfg))
        if not live:
            break
        for tid, cfg in live:
            result = {metric: value_of(cfg)}
            for b in budgets:
                result = dict(result, training_iteration=b)
                searcher.on_trial_result(tid, result)
            searcher.on_trial_complete(tid, result)
    return out


def _equal_on_both(make, spec=space, value_of=score_of, n=12, **kwargs):
    want, got = (_sequence(t, make, spec, value_of, n, **kwargs)
                 for _, t in SIDES)
    assert got == want
    return got


def _configs(analysis):
    return sorted(tuple(sorted(t.config.items())) for t in analysis.trials)


def test_random_searcher_end_to_end(port_rt):
    seq = _equal_on_both(lambda s: s.RandomSearcher(seed=0), n=12)
    assert len(seq) == 12

    def run(tune):
        return tune.run(objective_for(tune), config=space(tune),
                        num_samples=12, metric="score", mode="max",
                        search_alg=tune.suggest.RandomSearcher(seed=0))

    analysis = run(ttune)
    assert len(analysis.trials) == 12
    assert analysis.best_result["score"] <= 10
    # random suggestions do not depend on results: the same configs
    assert _configs(analysis) == _configs(_on_jax(run))


def test_tpe_concentrates_near_optimum(port_rt):
    _equal_on_both(lambda s: s.TPESearcher(n_initial_points=8, seed=1),
                   n=40)
    _equal_on_both(lambda s: s.TPESearcher(n_initial_points=8, seed=1),
                   n=40, batch=4)
    searcher = ttune.suggest.TPESearcher(n_initial_points=8, seed=1)
    analysis = ttune.run(objective_for(ttune), config=space(ttune),
                         num_samples=40, metric="score", mode="max",
                         search_alg=searcher)
    assert analysis.best_result["score"] > 9.0
    assert abs(analysis.best_config["x"] - 3.0) < 1.0


def test_bayesopt_concentrates_near_optimum(port_rt):
    _equal_on_both(lambda s: s.BayesOptSearcher(n_initial_points=6,
                                                seed=2), n=30)
    _equal_on_both(lambda s: s.BayesOptSearcher(n_initial_points=6,
                                                seed=2), n=30, batch=3)
    searcher = ttune.suggest.BayesOptSearcher(n_initial_points=6, seed=2)
    analysis = ttune.run(objective_for(ttune), config=space(ttune),
                         num_samples=30, metric="score", mode="max",
                         search_alg=searcher)
    assert analysis.best_result["score"] > 9.0


def _loss(config):
    return (config["x"] - 3.0) ** 2


def test_min_mode(port_rt):
    _equal_on_both(lambda s: s.TPESearcher(n_initial_points=8, seed=3),
                   value_of=_loss, n=40, metric="loss", mode="min")

    def obj(config):
        ttune.report(loss=_loss(config))

    searcher = ttune.suggest.TPESearcher(n_initial_points=8, seed=3)
    analysis = ttune.run(obj, config=space(ttune), num_samples=40,
                         metric="loss", mode="min", search_alg=searcher)
    assert analysis.best_result["loss"] < 1.0


def _mixed_space(tune):
    return {"kind": tune.choice(["a", "b", "c"]),
            "n": tune.randint(0, 20),
            "lr": tune.loguniform(1e-4, 1.0)}


def _mixed_score(config):
    bonus = {"a": 0.0, "b": 2.0, "c": -1.0}[config["kind"]]
    return -abs(config["n"] - 7) + bonus - abs(config["lr"] - 1e-2) * 10


def test_mixed_space_tpe(port_rt):
    _equal_on_both(lambda s: s.TPESearcher(n_initial_points=10, seed=4),
                   spec=_mixed_space, value_of=_mixed_score, n=50)

    def obj(config):
        ttune.report(score=_mixed_score(config))

    searcher = ttune.suggest.TPESearcher(n_initial_points=10, seed=4)
    analysis = ttune.run(obj, config=_mixed_space(ttune), num_samples=50,
                         metric="score", mode="max", search_alg=searcher)
    assert analysis.best_config["kind"] == "b"
    assert abs(analysis.best_config["n"] - 7) <= 2


def test_concurrency_limiter_bounds_live_trials():
    def scenario(tune):
        limiter = tune.suggest.ConcurrencyLimiter(
            tune.suggest.RandomSearcher(seed=5), max_concurrent=2)
        limiter.set_search_properties("score", "max", space(tune))
        s1, s2, s3 = (limiter.suggest(t) for t in ("t1", "t2", "t3"))
        limiter.on_trial_complete("t1", {"score": 1.0})
        return s1, s2, s3, limiter.suggest("t4")

    want, got = (scenario(t) for _, t in SIDES)
    assert got == want
    s1, s2, s3, s4 = got
    assert isinstance(s1, dict) and isinstance(s2, dict)
    assert s3 is None  # at the cap
    assert isinstance(s4, dict)


def test_concurrency_limiter_end_to_end(port_rt):
    seq = _equal_on_both(lambda s: s.ConcurrencyLimiter(
        s.RandomSearcher(seed=6), max_concurrent=2), n=8, batch=3)
    # the third of each batch of 3 finds the cap
    assert len(seq) == 9 and seq[2::3] == [None] * 3

    def run(tune):
        searcher = tune.suggest.ConcurrencyLimiter(
            tune.suggest.RandomSearcher(seed=6), max_concurrent=2)
        return tune.run(objective_for(tune), config=space(tune),
                        num_samples=8, metric="score", mode="max",
                        search_alg=searcher)

    analysis = run(ttune)
    assert len(analysis.trials) == 8
    assert _configs(analysis) == _configs(_on_jax(run))


def _recording(tune, seed):
    class Recording(tune.suggest.RandomSearcher):
        def __init__(self):
            super().__init__(seed=seed)
            self.completed = []

        def on_trial_complete(self, trial_id, result=None, error=False):
            self.completed.append((trial_id, result, error))

    return Recording()


def test_repeater_averages_groups():
    def scenario(tune):
        inner = _recording(tune, 7)
        rep = tune.suggest.Repeater(inner, repeat=3)
        rep.set_search_properties("score", "max", space(tune))
        configs = [rep.suggest(t) for t in ("t1", "t2", "t3")]
        rep.on_trial_complete("t1", {"score": 1.0})
        rep.on_trial_complete("t2", {"score": 2.0})
        before = list(inner.completed)
        rep.on_trial_complete("t3", {"score": 3.0})
        return configs, before, inner.completed, rep.suggest("t4")

    want, got = (scenario(t) for _, t in SIDES)
    assert got == want
    (c1, c2, c3), before, completed, c4 = got
    assert c1 == c2 == c3 and c4 != c1  # one suggestion, repeated 3x
    assert not before
    [(gid, result, error)] = completed
    assert result["score"] == pytest.approx(2.0) and not error


def test_basic_variant_generator_as_search_alg(port_rt):
    def grid(tune):
        return {"x": tune.grid_search([1.0, 3.0, 5.0])}

    seq = _equal_on_both(lambda s: s.BasicVariantGenerator(num_samples=2),
                         spec=grid, n=100)
    assert seq[:6] == [{"x": x} for x in (1.0, 3.0, 5.0)] * 2
    assert seq[6] == "FINISHED"
    analysis = ttune.run(
        objective_for(ttune), config=grid(ttune), num_samples=100,
        metric="score", mode="max",
        search_alg=ttune.suggest.BasicVariantGenerator(num_samples=2))
    # 3 grid points x 2 samples = 6 trials, not 100
    assert len(analysis.trials) == 6
    assert analysis.best_config["x"] == 3.0


def test_searcher_finished_sentinel():
    seq = _equal_on_both(lambda s: s.RandomSearcher(max_suggestions=2,
                                                    seed=8), n=3)
    assert isinstance(seq[0], dict) and isinstance(seq[1], dict)
    assert seq[2] is ttune.suggest.FINISHED == jtune.suggest.FINISHED


def test_grid_search_rejected_by_model_searchers(port_rt):
    for _, tune in SIDES:
        for searcher in (tune.suggest.TPESearcher(),
                         tune.suggest.BayesOptSearcher()):
            with pytest.raises(ValueError, match="grid_search"):
                searcher.set_search_properties(
                    "score", "max", {"x": tune.grid_search([1.0, 2.0])})
    with pytest.raises(ValueError, match="grid_search"):
        ttune.run(objective_for(ttune),
                  config={"x": ttune.grid_search([1.0, 2.0])},
                  num_samples=4, metric="score", mode="max",
                  search_alg=ttune.suggest.TPESearcher())


def _noisy_space(tune):
    return {"x": tune.uniform(-10, 10), "noise": tune.randn(0.0, 0.1)}


def test_function_domains_stay_sample_only(port_rt):
    # sample_from/randn domains have no bounds; model-based searchers
    # sample them (from the global random) rather than model them
    for make in (lambda s: s.TPESearcher(n_initial_points=3, seed=10),
                 lambda s: s.BayesOptSearcher(n_initial_points=3, seed=11)):
        seq = _equal_on_both(make, spec=_noisy_space, n=10, seed=12)
        assert len({c["noise"] for c in seq}) == 10
    searcher = ttune.suggest.TPESearcher(n_initial_points=3, seed=10)
    analysis = ttune.run(objective_for(ttune), config=_noisy_space(ttune),
                         num_samples=10, metric="score", mode="max",
                         search_alg=searcher)
    assert len(analysis.trials) == 10
    searcher2 = ttune.suggest.BayesOptSearcher(n_initial_points=3, seed=11)
    analysis2 = ttune.run(objective_for(ttune), config=_noisy_space(ttune),
                          num_samples=8, metric="score", mode="max",
                          search_alg=searcher2)
    assert len(analysis2.trials) == 8


def test_repeater_closes_group_with_errored_repeat():
    def scenario(tune):
        inner = _recording(tune, 12)
        rep = tune.suggest.Repeater(inner, repeat=3)
        rep.set_search_properties("score", "max", space(tune))
        configs = [rep.suggest(t) for t in ("t1", "t2", "t3")]
        rep.on_trial_complete("t1", error=True)  # one repeat fails
        rep.on_trial_complete("t2", {"score": 2.0})
        rep.on_trial_complete("t3", {"score": 4.0})
        return configs, inner.completed

    want, got = (scenario(t) for _, t in SIDES)
    assert got == want
    # the group closes despite the error, its mean over the successes
    [(_gid, result, error)] = got[1]
    assert not error and result["score"] == pytest.approx(3.0)


def test_searcher_not_drained_when_resources_blocked():
    # a pending trial blocked on resources must not make the runner pull
    # every remaining suggestion before any results exist
    def scenario(tune):
        class Counting(tune.suggest.RandomSearcher):
            def __init__(self):
                super().__init__(seed=13)
                self.suggested = 0
                self.completed = 0
                self.max_ahead = 0

            def suggest(self, trial_id):
                self.suggested += 1
                self.max_ahead = max(self.max_ahead,
                                     self.suggested - self.completed)
                return super().suggest(trial_id)

            def on_trial_complete(self, trial_id, result=None,
                                  error=False):
                self.completed += 1

        def heavy(config):
            tune.report(score=1.0)

        searcher = Counting()
        analysis = tune.run(heavy, config=space(tune), num_samples=20,
                            metric="score", mode="max", search_alg=searcher,
                            resources_per_trial={"cpu": 4})
        return searcher.suggested, searcher.max_ahead, _configs(analysis)

    want = _on_jax(scenario)
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        got = scenario(ttune)
    finally:
        ray_tpu_torch.shutdown()
    suggested, max_ahead, configs = got
    assert suggested == 20 and max_ahead <= 3
    assert configs == want[2]


def test_search_alg_with_scheduler(port_rt):
    def run(tune):
        def obj(config):
            for i in range(5):
                tune.report(score=config["x"] * (i + 1))

        return tune.run(
            obj, config={"x": tune.uniform(0, 1)}, num_samples=8,
            metric="score", mode="max",
            scheduler=tune.AsyncHyperBandScheduler(metric="score",
                                                   mode="max",
                                                   grace_period=1),
            search_alg=tune.suggest.RandomSearcher(seed=9))

    analysis = run(ttune)
    assert len(analysis.trials) == 8
    assert _configs(analysis) == _configs(_on_jax(run))


# ---------------------------------------------------------------- external
class _AskTellQuadOpt:
    """Stand-in for an external ask/tell library (optuna's study.ask/
    study.tell shape): proposes candidates, learns from tells by
    contracting around the best observation."""

    def __init__(self, lo=-10.0, hi=10.0, budget=16):
        self._rng = random.Random(0)
        self.lo, self.hi = lo, hi
        self.budget = budget
        self.best = None  # (value, x)
        self.asked = 0
        self.tells = []

    def ask(self):
        if self.asked >= self.budget:
            return None  # exhausted -> Searcher returns FINISHED
        self.asked += 1
        if self.best is not None and self.asked % 2 == 0:
            center = self.best[1]
            span = (self.hi - self.lo) / self.asked
            x = center + self._rng.uniform(-span, span)
        else:
            x = self._rng.uniform(self.lo, self.hi)
        return {"x": x}

    def tell(self, params, value):
        self.tells.append((params["x"], value))
        if self.best is None or value > self.best[0]:
            self.best = (value, params["x"])


def _ask_tell_on_both(n, budget, value_of=score_of, **kwargs):
    """The adapter's suggestions and the optimizer's tells, equal on both
    packages -> the port's (suggestions, optimizer)."""
    runs = []
    for _, tune in SIDES:
        opt = _AskTellQuadOpt(budget=budget)
        seq = _sequence(tune, lambda s: s.AskTellSearcher(opt), space,
                        value_of, n, **kwargs)
        runs.append((seq, opt))
    (want, want_opt), (got, got_opt) = runs
    assert got == want and got_opt.tells == want_opt.tells
    return got, got_opt


def test_external_ask_tell_adapter_end_to_end(port_rt):
    """An external ask/tell optimizer drives tune.run through
    AskTellSearcher; every completed trial is told back."""
    from ray_tpu_torch.tune.suggest.external import AskTellSearcher

    seq, _ = _ask_tell_on_both(n=50, budget=14)
    assert len(seq) == 15 and seq[-1] == "FINISHED"
    opt = _AskTellQuadOpt(budget=14)
    analysis = ttune.run(objective_for(ttune), config=space(ttune),
                         num_samples=50, metric="score", mode="max",
                         search_alg=AskTellSearcher(opt))
    # the external budget bounds trial count (FINISHED honored)
    assert len(analysis.trials) == 14
    assert opt.asked == 14
    assert len(opt.tells) == 14  # every completion was told back
    assert analysis.best_result["score"] <= 10
    # maximization normalization reached the optimizer
    assert opt.best[0] == pytest.approx(max(v for _, v in opt.tells))


def test_external_adapter_min_mode_normalizes_sign(port_rt):
    from ray_tpu_torch.tune.suggest.external import AskTellSearcher

    _, seq_opt = _ask_tell_on_both(n=20, budget=10, value_of=_loss,
                                   metric="loss", mode="min")
    assert all(v <= 0 for _, v in seq_opt.tells)

    def min_objective(config):
        ttune.report(loss=_loss(config))

    opt = _AskTellQuadOpt(budget=10)
    ttune.run(min_objective, config=space(ttune), num_samples=20,
              metric="loss", mode="min", search_alg=AskTellSearcher(opt))
    # mode=min: the adapter tells NEGATED losses, so the optimizer's
    # "best" (max) is the smallest loss
    assert opt.best[0] == pytest.approx(max(v for _, v in opt.tells))
    assert all(v <= 0 for _, v in opt.tells)


def test_bohb_searcher_suggestions_match_jax():
    """BOHB's multi-fidelity TPE: results at budgets 1, 3 and 9 fill its
    per-budget buckets alike on both packages, and its suggestions, which
    come from the deepest bucket with enough observations, are equal."""
    from ray_tpu.tune.suggest.bohb import BOHBSearcher as JBOHB
    from ray_tpu_torch.tune.suggest.bohb import BOHBSearcher as TBOHB

    makers = {jtune: JBOHB, ttune: TBOHB}
    seqs, buckets = [], []
    for _, tune in SIDES:
        made = []

        def make(_s, cls=makers[tune], made=made):
            made.append(cls(n_initial_points=3, seed=3))
            return made[-1]

        seqs.append(_sequence(tune, make, space, score_of, 16, batch=2,
                              budgets=(1, 3, 9)))
        buckets.append({b: sorted(v) for b, v in made[0]._buckets.items()})
    assert seqs[1] == seqs[0]
    assert buckets[1] == buckets[0] and sorted(buckets[1]) == [1.0, 3.0,
                                                               9.0]
