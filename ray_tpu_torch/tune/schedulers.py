"""Trial schedulers.

Mirrors the reference's ray.tune.schedulers: FIFOScheduler,
AsyncHyperBandScheduler/ASHA (schedulers/async_hyperband.py),
MedianStoppingRule (median_stopping_rule.py), HyperBandScheduler
(hyperband.py, simplified to successive halving brackets), and
PopulationBasedTraining (pbt.py: exploit via checkpoint copy + explore
via mutation).
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.tune.trial import Trial


class TrialScheduler:
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"

    def on_trial_add(self, runner, trial: Trial) -> None:
        pass

    def on_trial_result(self, runner, trial: Trial, result: Dict) -> str:
        return TrialScheduler.CONTINUE

    def on_trial_complete(self, runner, trial: Trial, result: Dict) -> None:
        pass

    def on_trial_remove(self, runner, trial: Trial) -> None:
        pass

    def choose_trial_to_run(self, runner) -> Optional[Trial]:
        for t in runner.trials:
            if t.status == Trial.PENDING and runner.has_resources_for(t):
                return t
        return None


class FIFOScheduler(TrialScheduler):
    pass


def _get_metric(result: Dict, metric: str, mode: str) -> Optional[float]:
    v = result.get(metric)
    if v is None:
        return None
    return float(v) if mode == "max" else -float(v)


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: asynchronous successive halving. At each rung (iteration
    milestone r*eta^k), stop a trial whose metric falls below the rung's
    top-1/eta quantile (reference schedulers/async_hyperband.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4, brackets: int = 1):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung -> recorded (negated-if-min) metric values
        self._rungs: Dict[float, List[float]] = {}
        milestone = grace_period
        while milestone < max_t:
            self._rungs.setdefault(milestone, [])
            milestone = int(milestone * self.rf)

    def on_trial_result(self, runner, trial: Trial, result: Dict) -> str:
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return TrialScheduler.STOP
        value = _get_metric(result, self.metric, self.mode)
        if value is None:
            return TrialScheduler.CONTINUE
        action = TrialScheduler.CONTINUE
        for milestone in sorted(self._rungs, reverse=True):
            if t < milestone:
                continue
            recorded = self._rungs[milestone]
            if recorded:
                k = max(1, int(len(recorded) / self.rf))
                cutoff = sorted(recorded, reverse=True)[k - 1]
                if value < cutoff:
                    action = TrialScheduler.STOP
            recorded.append(value)
            break
        return action


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result is worse than the median of other
    trials' running means at the same point in time
    (reference schedulers/median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._results: Dict[str, List[float]] = {}

    def on_trial_result(self, runner, trial: Trial, result: Dict) -> str:
        value = _get_metric(result, self.metric, self.mode)
        t = result.get(self.time_attr, 0)
        if value is None:
            return TrialScheduler.CONTINUE
        self._results.setdefault(trial.trial_id, []).append(value)
        if t < self.grace_period:
            return TrialScheduler.CONTINUE
        means = [sum(v) / len(v) for tid, v in self._results.items()
                 if tid != trial.trial_id and v]
        if len(means) < self.min_samples:
            return TrialScheduler.CONTINUE
        median = sorted(means)[len(means) // 2]
        best = max(self._results[trial.trial_id])
        return TrialScheduler.STOP if best < median \
            else TrialScheduler.CONTINUE


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (reference schedulers/hyperband.py): trials
    fill brackets; each bracket runs successive-halving rounds — all its
    trials run to the round's milestone, then only the top 1/eta continue
    (PAUSE at the milestone, bottom trials STOP when the round closes).

    Unlike ASHA (AsyncHyperBandScheduler) the halving decision waits for
    every live trial in the bracket to reach the milestone, trading
    stragglers for exact quantiles."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 max_t: int = 81, reduction_factor: float = 3):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.eta = reduction_factor
        # s_max+1 bracket shapes, bracket s: n = ceil((s_max+1)/(s+1) *
        # eta^s) trials starting at r = max_t / eta^s iterations.
        # Integer loop, not int(log(...)): float log truncates exact
        # powers (log(243, 3) == 4.999...).
        s = 0
        while self.eta ** (s + 1) <= max_t:
            s += 1
        self._s_max = s
        self._brackets: List[dict] = []
        self._trial_bracket: Dict[str, dict] = {}

    def _new_bracket(self) -> dict:
        s = self._s_max - (len(self._brackets) % (self._s_max + 1))
        n = int(math.ceil((self._s_max + 1) / (s + 1) * self.eta ** s))
        r = max(1, int(self.max_t / self.eta ** s))
        bracket = {"s": s, "capacity": n, "milestone": r,
                   "trials": {}, "results": {}}
        self._brackets.append(bracket)
        return bracket

    def on_trial_add(self, runner, trial: Trial) -> None:
        for bracket in self._brackets:
            if len(bracket["trials"]) < bracket["capacity"]:
                break
        else:
            bracket = self._new_bracket()
        bracket["trials"][trial.trial_id] = trial
        self._trial_bracket[trial.trial_id] = bracket

    def on_trial_result(self, runner, trial: Trial, result: Dict) -> str:
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return TrialScheduler.STOP
        bracket = self._trial_bracket.get(trial.trial_id)
        if bracket is None:
            return TrialScheduler.CONTINUE
        if t < bracket["milestone"]:
            return TrialScheduler.CONTINUE
        # AT (or past) the milestone: record the score that counts for
        # this round — pre-milestone reports must not enter the ranking,
        # or concurrent trials would be halved at mixed iteration counts.
        value = _get_metric(result, self.metric, self.mode)
        if value is None:
            return TrialScheduler.CONTINUE  # nothing comparable reported
        bracket["results"][trial.trial_id] = value
        return self._maybe_close_round(runner, bracket, trial)

    def on_trial_complete(self, runner, trial: Trial, result: Dict) -> None:
        # a trial leaving through the stop criterion (runner completes it
        # BEFORE consulting the scheduler) must not stall its round
        self._forget(runner, trial)

    def on_trial_remove(self, runner, trial: Trial) -> None:
        self._forget(runner, trial)

    def _forget(self, runner, trial: Trial) -> None:
        bracket = self._trial_bracket.pop(trial.trial_id, None)
        if bracket is None:
            return
        bracket["results"].pop(trial.trial_id, None)
        # its departure may have been the round's last missing report
        if any(tr.status not in (Trial.TERMINATED, Trial.ERROR)
               for tr in bracket["trials"].values()):
            self._maybe_close_round(runner, bracket, None)

    def _maybe_close_round(self, runner, bracket: dict,
                           trial: Optional[Trial]) -> str:
        live = [tid for tid, tr in bracket["trials"].items()
                if tr.status not in (Trial.TERMINATED, Trial.ERROR)
                and tid in self._trial_bracket]
        reported = [tid for tid in live if tid in bracket["results"]]
        waiting = [tid for tid in live if tid not in reported]
        if waiting or not reported:
            return TrialScheduler.PAUSE  # stragglers still mid-round
        # whole round in: keep the top 1/eta, stop the rest
        ranked = sorted(reported,
                        key=lambda tid: bracket["results"][tid],
                        reverse=True)
        keep = max(1, int(len(ranked) / self.eta))
        survivors = set(ranked[:keep])
        bracket["milestone"] = min(self.max_t,
                                   int(bracket["milestone"] * self.eta))
        bracket["results"] = {}
        for tid in list(ranked):
            if tid in survivors:
                continue
            tr = bracket["trials"][tid]
            if trial is not None and tr is trial:
                continue  # returned as STOP below
            runner._complete_trial(tr, {})
        for tid in survivors:
            tr = bracket["trials"][tid]
            if tr.status == Trial.PAUSED:
                tr.status = Trial.PENDING  # resume the next round
        if trial is None:
            return TrialScheduler.CONTINUE
        return (TrialScheduler.CONTINUE if trial.trial_id in survivors
                else TrialScheduler.STOP)


class PopulationBasedTraining(TrialScheduler):
    """PBT: at each perturbation interval, a bottom-quantile trial clones
    the checkpoint of a top-quantile trial (exploit) and perturbs its
    hyperparameters (explore) — reference schedulers/pbt.py."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._last_perturb: Dict[str, float] = {}
        self._scores: Dict[str, float] = {}
        self._rng = random.Random(seed)
        self.num_perturbations = 0

    def on_trial_result(self, runner, trial: Trial, result: Dict) -> str:
        t = result.get(self.time_attr, 0)
        score = _get_metric(result, self.metric, self.mode)
        if score is not None:
            self._scores[trial.trial_id] = score
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return TrialScheduler.CONTINUE
        self._last_perturb[trial.trial_id] = t
        lower, upper = self._quantiles(runner)
        if trial.trial_id in {x.trial_id for x in lower} and upper:
            donor = self._rng.choice(upper)
            self._exploit(runner, trial, donor)
        return TrialScheduler.CONTINUE

    def _quantiles(self, runner):
        trials = [tr for tr in runner.trials
                  if tr.trial_id in self._scores
                  and tr.status in (Trial.RUNNING, Trial.PENDING,
                                    Trial.PAUSED)]
        if len(trials) <= 1:
            return [], []
        trials.sort(key=lambda tr: self._scores[tr.trial_id])
        n = max(1, int(math.ceil(len(trials) * self.quantile)))
        if n > len(trials) // 2:
            n = len(trials) // 2
        return trials[:n], trials[-n:] if n else []

    def _exploit(self, runner, trial: Trial, donor: Trial) -> None:
        checkpoint = runner.save_trial(donor)
        if checkpoint is None:
            return
        new_config = self._explore(dict(donor.config))
        trial.config = new_config
        runner.restart_trial_with(trial, new_config, checkpoint)
        self.num_perturbations += 1

    def _explore(self, config: Dict) -> Dict:
        from ray_tpu_torch.tune.sample import Domain

        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob or \
                    key not in config:
                if isinstance(spec, list):
                    config[key] = self._rng.choice(spec)
                elif isinstance(spec, Domain):
                    config[key] = spec.sample(self._rng)
                elif callable(spec):
                    config[key] = spec()
            else:
                factor = self._rng.choice([0.8, 1.2])
                if isinstance(spec, list):
                    # move to a neighboring value
                    try:
                        i = spec.index(config[key])
                        i = max(0, min(len(spec) - 1,
                                       i + self._rng.choice([-1, 1])))
                        config[key] = spec[i]
                    except ValueError:
                        config[key] = self._rng.choice(spec)
                elif isinstance(config[key], (int, float)):
                    config[key] = type(config[key])(config[key] * factor)
        return config


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand variant for BOHB (reference: schedulers/hb_bohb.py):
    identical bracket math, but trial selection fills the round closest
    to completion first, so the BOHBSearcher's per-budget model gets
    whole rungs of feedback as early as possible instead of dribbling
    results across many half-filled brackets. Pair with
    suggest.bohb.BOHBSearcher as search_alg."""

    def choose_trial_to_run(self, runner) -> Optional[Trial]:
        candidates = [t for t in runner.trials
                      if t.status == Trial.PENDING
                      and runner.has_resources_for(t)]
        if not candidates:
            return None

        def missing_reports(t: Trial):
            bracket = self._trial_bracket.get(t.trial_id)
            if bracket is None:
                return (1, 0)
            live = [tid for tid, tr in bracket["trials"].items()
                    if tr.status not in (Trial.TERMINATED, Trial.ERROR)]
            missing = sum(1 for tid in live
                          if tid not in bracket["results"])
            return (0, missing)

        return min(candidates, key=missing_reports)


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: schedulers/pb2.py, Parker-
    Holder et al. 2020): PBT's exploit step (clone a top trial's
    checkpoint) is kept, but the EXPLORE step replaces random
    perturbation with a Gaussian-process bandit — fit a GP to the
    population's (hyperparameters -> score) observations and take the
    UCB argmax inside ``hyperparam_bounds``. Numpy-native (RBF kernel
    ridge posterior), like the repo's other model-based searchers."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 ucb_beta: float = 2.0,
                 n_candidates: int = 256,
                 seed: Optional[int] = None):
        super().__init__(time_attr=time_attr, metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction,
                         seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds: "
                             "{key: (low, high)}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.ucb_beta = ucb_beta
        self.n_candidates = n_candidates
        self._runner = None

    def on_trial_result(self, runner, trial: Trial, result: Dict) -> str:
        self._runner = runner  # _explore needs population observations
        return super().on_trial_result(runner, trial, result)

    def _observations(self):
        import numpy as np

        keys = list(self.bounds)
        X, y = [], []
        for tr in (self._runner.trials if self._runner else []):
            score = self._scores.get(tr.trial_id)
            if score is None:
                continue
            row = []
            for k in keys:
                lo, hi = self.bounds[k]
                v = float(tr.config.get(k, lo))
                row.append((v - lo) / max(1e-12, hi - lo))
            X.append(row)
            y.append(score)
        return np.asarray(X, dtype=float), np.asarray(y, dtype=float)

    def _explore(self, config: Dict) -> Dict:
        import numpy as np

        keys = list(self.bounds)
        X, y = self._observations()
        rng = np.random.default_rng(self._rng.randrange(2 ** 31))
        cands = rng.uniform(size=(self.n_candidates, len(keys)))
        if len(y) >= 3 and float(y.std()) > 0:
            ys = (y - y.mean()) / y.std()

            def rbf(a, b, ls=0.2):
                d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                return np.exp(-d2 / (2 * ls * ls))

            K = rbf(X, X) + 1e-3 * np.eye(len(X))
            Kinv = np.linalg.inv(K)
            ks = rbf(cands, X)
            mu = ks @ (Kinv @ ys)
            var = np.clip(1.0 - np.einsum("ci,ij,cj->c", ks, Kinv, ks),
                          1e-9, None)
            ucb = mu + self.ucb_beta * np.sqrt(var)
            best = cands[int(np.argmax(ucb))]
        else:  # cold start: uniform exploration inside the bounds
            best = cands[0]
        for i, k in enumerate(keys):
            lo, hi = self.bounds[k]
            value = lo + float(best[i]) * (hi - lo)
            if isinstance(config.get(k), int):
                value = int(round(value))
            config[k] = value
        return config
