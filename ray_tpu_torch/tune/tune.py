"""tune.run — the experiment entry point.

Mirrors the reference's ray.tune.run (python/ray/tune/tune.py): expand
the config into trials (grid × num_samples), drive them through the
TrialRunner under the chosen scheduler, return an ExperimentAnalysis.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.tune.analysis import ExperimentAnalysis
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.trainable import Trainable, wrap_function
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.trial_runner import TrialRunner
from ray_tpu_torch.tune.variant_generator import generate_variants


def run(run_or_experiment: Union[Callable, type],
        *,
        config: Optional[Dict] = None,
        num_samples: int = 1,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        stop: Optional[Union[Dict, Callable]] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        scheduler: Optional[TrialScheduler] = None,
        search_alg: Any = None,
        max_failures: int = 0,
        max_concurrent_trials: Optional[int] = None,
        callbacks: Optional[List] = None,
        verbose: int = 0,
        name: Optional[str] = None,
        seed: Optional[int] = None,
        local_dir: Optional[str] = None,
        resume: bool = False,
        sync_config: Optional[Dict] = None,
        **_ignored) -> ExperimentAnalysis:
    """``local_dir``/``name`` place the experiment directory;
    ``resume=True`` reloads a previous run's state from it (finished
    trials keep their results, unfinished ones restart from their last
    checkpoint — reference: tune.run(resume=...) over the trial_runner
    experiment checkpoint); ``sync_config={"upload_dir": ...}`` mirrors
    the experiment dir through a Syncer (tune/syncer.py)."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    if isinstance(run_or_experiment, type) and \
            issubclass(run_or_experiment, Trainable):
        trainable_cls = run_or_experiment
    elif callable(run_or_experiment):
        trainable_cls = wrap_function(run_or_experiment)
    else:
        raise TypeError("run_or_experiment must be a callable or a "
                        "Trainable subclass")
    if scheduler is not None:
        # let the experiment's metric/mode flow into the scheduler like
        # the reference's set_search_properties
        if metric and getattr(scheduler, "metric", None) in (
                None, "episode_reward_mean"):
            scheduler.metric = metric
        if mode and getattr(scheduler, "mode", None) in (None, "max"):
            scheduler.mode = mode

    import os

    from ray_tpu_torch.tune import syncer as sync_mod

    # experiment state persists only when the caller identified the
    # experiment (name/local_dir) or asked for durability — a bare
    # tune.run(train_fn) must not clobber another same-named function's
    # resume state in the shared default directory
    persist = bool(name or local_dir or resume or sync_config)
    exp_name = name or getattr(trainable_cls, "__name__", "experiment")
    exp_dir = os.path.join(local_dir or sync_mod.default_local_dir(),
                           exp_name)
    upload_dir = (sync_config or {}).get("upload_dir")
    the_syncer = sync_mod.get_syncer(upload_dir)
    restored: List[Trial] = []       # finished trials from a prior run
    resumable: dict = {}             # trial_id -> saved state to re-run
    if resume:
        if the_syncer is not None and upload_dir and \
                sync_mod.load_experiment_state(exp_dir) is None:
            the_syncer.sync_down(upload_dir, exp_dir)
        state = sync_mod.load_experiment_state(exp_dir)
        for saved in (state or {}).get("trials", []):
            if saved["status"] in (Trial.TERMINATED, Trial.ERROR):
                t = Trial(trainable_cls=trainable_cls,
                          config=saved["config"],
                          experiment_tag=saved["experiment_tag"])
                t.trial_id = saved["trial_id"]
                t.status = saved["status"]
                t.last_result = saved["last_result"]
                t.results = saved["results"]
                t.error = saved["error"]
                restored.append(t)
                for r in saved["results"]:  # get_best_trial(scope="all")
                    for k, v in r.items():
                        if isinstance(v, (int, float)):
                            t.metric_history.setdefault(k, []).append(
                                float(v))
            else:
                resumable[saved["experiment_tag"]] = saved

    rng = random.Random(seed)
    config = config or {}
    if search_alg is not None:
        # Searcher-driven: trials are created lazily from suggestions
        # (reference: SearchGenerator). num_samples bounds the total.
        search_alg.set_search_properties(metric, mode, config)

        def _factory(variant: Dict, trial_id: str) -> Trial:
            trial = Trial(
                trainable_cls=trainable_cls,
                config=variant,
                experiment_tag=trial_id,
                resources=resources_per_trial,
                stopping_criterion=stop,
                max_failures=max_failures)
            trial.trial_id = trial_id
            return trial

        # resume with a searcher: suggestions are not replayable by tag,
        # so completed trials simply reduce the remaining budget (their
        # results still reach the analysis via `restored`)
        remaining = max(0, num_samples - len(restored))
        runner = TrialRunner(scheduler=scheduler,
                             max_concurrent_trials=max_concurrent_trials,
                             callbacks=callbacks,
                             search_alg=search_alg,
                             trial_factory=_factory,
                             max_trials=remaining)
        # restored searcher trials were named trial_0..trial_{k-1}:
        # start new suggestions after them
        runner._trial_counter = len(restored)
        runner.trial_id_offset = len(restored)
    else:
        runner = TrialRunner(scheduler=scheduler,
                             max_concurrent_trials=max_concurrent_trials,
                             callbacks=callbacks)
        trial_idx = 0
        done_tags = {t.experiment_tag for t in restored}
        for _ in range(num_samples):
            for tag, variant in generate_variants(config, rng):
                full_tag = f"{trial_idx}" + (f"_{tag}" if tag else "")
                trial_idx += 1
                if full_tag in done_tags:
                    continue  # finished in the resumed run
                trial = Trial(
                    trainable_cls=trainable_cls,
                    config=variant,
                    experiment_tag=full_tag,
                    resources=resources_per_trial,
                    stopping_criterion=stop,
                    max_failures=max_failures)
                saved = resumable.get(full_tag)
                if saved is not None:  # continue from its checkpoint
                    trial.trial_id = saved["trial_id"]
                    trial.config = saved["config"]
                    trial.checkpoint = saved["checkpoint"]
                    trial.results = saved["results"]
                    trial.last_result = saved["last_result"]
                runner.add_trial(trial)
    checkpointer = None
    if persist:
        checkpointer = sync_mod.ExperimentCheckpointCallback(
            exp_dir, the_syncer, upload_dir, extra_trials=restored)
        runner.callbacks.append(checkpointer)
    try:
        runner.run_loop()
    finally:
        if checkpointer is not None:
            checkpointer.flush(runner.trials)
    if verbose:
        for t in runner.trials:
            print(f"{t}: {t.status} {t.last_result}")
    return ExperimentAnalysis(restored + runner.trials,
                              default_metric=metric, default_mode=mode)


def with_parameters(trainable: Callable, **kwargs) -> Callable:
    """Bind large objects by object-store reference
    (reference tune/utils/trainable.py with_parameters)."""
    refs = {k: ray_tpu_torch.put(v) for k, v in kwargs.items()}

    def inner(config, checkpoint_dir=None):
        resolved = {k: ray_tpu_torch.get(r) for k, r in refs.items()}
        import inspect

        sig = inspect.signature(trainable)
        if "checkpoint_dir" in sig.parameters:
            return trainable(config, checkpoint_dir=checkpoint_dir,
                             **resolved)
        return trainable(config, **resolved)

    inner.__name__ = getattr(trainable, "__name__", "trainable")
    return inner
