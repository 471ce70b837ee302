"""Trial runner — trials as actors, event loop on the driver.

Mirrors the reference's ray.tune TrialRunner + RayTrialExecutor
(python/ray/tune/trial_runner.py, ray_trial_executor.py): each trial's
Trainable is hosted in an actor; the runner keeps one in-flight
``train()`` call per running trial, processes completions in arrival
order via ray_tpu_torch.wait, and lets the scheduler stop/pause/perturb.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.trial import Trial

logger = logging.getLogger(__name__)


class TrialRunner:
    def __init__(self, scheduler: Optional[TrialScheduler] = None,
                 max_concurrent_trials: Optional[int] = None,
                 callbacks: Optional[List] = None,
                 search_alg=None,
                 trial_factory=None,
                 max_trials: Optional[int] = None):
        self.scheduler = scheduler or FIFOScheduler()
        self.trials: List[Trial] = []
        self.max_concurrent = max_concurrent_trials
        self.callbacks = list(callbacks) if callbacks else []
        self._in_flight: Dict[Any, Trial] = {}  # result ref -> trial
        self._actor_cls_cache: Dict[type, Any] = {}
        # search-algorithm plumbing (reference: trial_runner holds a
        # SearchGenerator wrapping the Searcher)
        self.search_alg = search_alg
        self._trial_factory = trial_factory
        self._max_trials = max_trials
        self._search_exhausted = search_alg is None
        self._trial_counter = 0
        # resume support: seed past a previous run's searcher trials so
        # new suggestions never reuse a restored trial's id
        self.trial_id_offset = 0

    # -------------------------------------------------------------- setup
    def add_trial(self, trial: Trial) -> None:
        self.trials.append(trial)
        self.scheduler.on_trial_add(self, trial)

    def is_finished(self) -> bool:
        return self._search_exhausted and all(
            t.status in (Trial.TERMINATED, Trial.ERROR)
            for t in self.trials)

    def has_resources_for(self, trial: Trial) -> bool:
        # Account against the runner's own committed demand, not the live
        # view: actor creation is asynchronous, so available_resources()
        # lags starts and would over-admit (the reference's trial
        # executor keeps its own committed-resources ledger the same way,
        # ray_trial_executor.py _committed_resources).
        total = ray_tpu_torch.cluster_resources()
        used = {"CPU": 0.0, "GPU": 0.0}
        for t in self.trials:
            if t.status != Trial.RUNNING:
                continue
            o = t.actor_options()
            used["CPU"] += o.get("num_cpus", 1)
            used["GPU"] += o.get("num_gpus", 0) or 0
            for k, v in (o.get("resources") or {}).items():
                used[k] = used.get(k, 0.0) + v
        opts = trial.actor_options()
        if total.get("CPU", 0) - used["CPU"] < opts.get("num_cpus", 1):
            return False
        if opts.get("num_gpus", 0) and \
                total.get("GPU", 0) - used["GPU"] < opts["num_gpus"]:
            return False
        for k, v in (opts.get("resources") or {}).items():
            if total.get(k, 0) - used.get(k, 0.0) < v:
                return False
        return True

    def _remote_cls(self, trainable_cls: type):
        if trainable_cls not in self._actor_cls_cache:
            self._actor_cls_cache[trainable_cls] = \
                ray_tpu_torch.remote(trainable_cls)
        return self._actor_cls_cache[trainable_cls]

    # ------------------------------------------------------------- running
    def _num_running(self) -> int:
        return sum(1 for t in self.trials if t.status == Trial.RUNNING)

    def _maybe_start_trials(self) -> None:
        while True:
            if self.max_concurrent and \
                    self._num_running() >= self.max_concurrent:
                return
            trial = self.scheduler.choose_trial_to_run(self)
            if trial is None:
                # Only pull a new suggestion when no created trial is
                # waiting to start — pending trials blocked on resources
                # must NOT drain the searcher (adaptive searchers need
                # completed results before suggesting more).
                if any(t.status == Trial.PENDING for t in self.trials):
                    return
                if not self._refill_from_searcher():
                    return
                continue
            self._start_trial(trial)

    def _refill_from_searcher(self) -> bool:
        """Pull the next suggestion into a new trial. Returns True if a
        trial was added (reference:
        SearchGenerator.create_trial_if_possible)."""
        if self._search_exhausted or self.search_alg is None:
            return False
        if self._max_trials is not None and \
                self._trial_counter - self.trial_id_offset \
                >= self._max_trials:
            self._search_exhausted = True
            return False
        from ray_tpu_torch.tune.suggest import FINISHED

        trial_id = f"trial_{self._trial_counter}"
        suggestion = self.search_alg.suggest(trial_id)
        if suggestion is FINISHED:
            self._search_exhausted = True
            return False
        if suggestion is None:
            # not ready (e.g. concurrency-limited). If nothing is running
            # that could ever unblock it, treat as exhausted to avoid a
            # live-lock.
            if not self._in_flight and not any(
                    t.status in (Trial.RUNNING, Trial.PENDING, Trial.PAUSED)
                    for t in self.trials):
                self._search_exhausted = True
            return False
        trial = self._trial_factory(suggestion, trial_id)
        self._trial_counter += 1
        self.add_trial(trial)
        return True

    def _start_trial(self, trial: Trial) -> None:
        cls = self._remote_cls(trial.trainable_cls)
        trial.runner = cls.options(**trial.actor_options()).remote(
            trial.config, trial.trial_id)
        if trial.checkpoint is not None:
            ray_tpu_torch.get(trial.runner.restore.remote(trial.checkpoint))
        trial.status = Trial.RUNNING
        self._queue_train(trial)

    def _queue_train(self, trial: Trial) -> None:
        ref = trial.runner.train.remote()
        self._in_flight[ref] = trial

    def step(self) -> None:
        """One event-loop turn."""
        self._maybe_start_trials()
        if not self._in_flight:
            return
        ready, _ = ray_tpu_torch.wait(list(self._in_flight), num_returns=1)
        ref = ready[0]
        trial = self._in_flight.pop(ref)
        if trial.status != Trial.RUNNING:
            return
        try:
            result = ray_tpu_torch.get(ref)
        except Exception as e:  # noqa: BLE001
            self._handle_trial_error(trial, e)
            return
        trial.update_result(result)
        for cb in self.callbacks:
            cb.on_trial_result(self, trial, result)
        if self.search_alg is not None:
            self.search_alg.on_trial_result(trial.trial_id, result)
        if trial.should_stop(result):
            self._complete_trial(trial, result)
            return
        decision = self.scheduler.on_trial_result(self, trial, result)
        if decision == TrialScheduler.STOP:
            self._complete_trial(trial, result)
        elif decision == TrialScheduler.PAUSE:
            self._pause_trial(trial)
        elif trial.status == Trial.RUNNING and trial.runner is not None:
            # the scheduler hook may have torn the actor down itself
            # (e.g. PBT exploit on a trainable whose reset_config fails,
            # which re-queues the trial as PENDING)
            self._queue_train(trial)

    def run_loop(self) -> None:
        while not self.is_finished():
            self.step()

    # ----------------------------------------------------------- lifecycle
    def _complete_trial(self, trial: Trial, result: Dict) -> None:
        trial.status = Trial.TERMINATED
        self.scheduler.on_trial_complete(self, trial, result)
        if self.search_alg is not None:
            self.search_alg.on_trial_complete(trial.trial_id, result)
        self._stop_actor(trial)

    def _pause_trial(self, trial: Trial) -> None:
        trial.checkpoint = ray_tpu_torch.get(trial.runner.save.remote())
        trial.status = Trial.PAUSED
        self._stop_actor(trial)

    def _handle_trial_error(self, trial: Trial, error: Exception) -> None:
        trial.num_failures += 1
        self._stop_actor(trial)
        if trial.num_failures <= trial.max_failures:
            logger.warning("trial %s failed (%d/%d); restarting from "
                           "checkpoint", trial, trial.num_failures,
                           trial.max_failures)
            trial.status = Trial.PENDING
            return
        trial.status = Trial.ERROR
        trial.error = repr(error)
        if self.search_alg is not None:
            self.search_alg.on_trial_complete(trial.trial_id, error=True)
        # synchronous schedulers (HyperBand) gate rounds on every live
        # bracket member; an errored trial must not stall its round
        self.scheduler.on_trial_remove(self, trial)

    def _stop_actor(self, trial: Trial) -> None:
        if trial.runner is not None:
            # drop any in-flight result from this incarnation
            for ref, t in list(self._in_flight.items()):
                if t is trial:
                    del self._in_flight[ref]
            try:
                ray_tpu_torch.get(trial.runner.stop.remote())
            except Exception:  # noqa: BLE001
                pass
            ray_tpu_torch.kill(trial.runner)
            trial.runner = None

    # ------------------------------------------------------ scheduler hooks
    def save_trial(self, trial: Trial) -> Optional[Dict]:
        if trial.runner is None:
            return trial.checkpoint
        try:
            return ray_tpu_torch.get(trial.runner.save.remote())
        except Exception:  # noqa: BLE001
            return None

    def restart_trial_with(self, trial: Trial, new_config: Dict,
                           checkpoint: Dict) -> None:
        """PBT exploit: reload `trial` from `checkpoint` with new config."""
        trial.config = new_config
        trial.checkpoint = checkpoint
        if trial.runner is None:
            return
        reset_ok = False
        try:
            reset_ok = ray_tpu_torch.get(
                trial.runner.reset.remote(new_config, trial.trial_id))
        except Exception:  # noqa: BLE001
            reset_ok = False
        if reset_ok:
            ray_tpu_torch.get(trial.runner.restore.remote(checkpoint))
        else:
            self._stop_actor(trial)
            trial.status = Trial.PENDING
