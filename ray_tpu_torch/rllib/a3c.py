"""A3C: asynchronous advantage actor-critic.

Reference behavior: rllib/agents/a3c/a3c.py — the ASYNC execution plan
(AsyncGradients): each rollout worker computes GRADIENTS from its own
fragment with whatever weights it has; the learner applies them the
moment any worker finishes (ray.wait on the in-flight set) and ships
fresh weights back to THAT worker only. Gradients are stale by up to
one round trip — the A3C trade, distinct from A2C's synchronous
sample-then-learn batch. Built on the compute_gradients/apply_gradients
seam of A2CPolicy.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.policy_extra import A2CPolicy
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker


class _GradientWorker(RolloutWorker):
    def sample_gradients(self, num_steps: int):
        """One fragment -> (grads, timesteps, stats), computed with this
        worker's CURRENT weights (possibly stale — that is A3C)."""
        batch = self.sample(num_steps)
        grads, stats = self.policy.compute_gradients(batch)
        return grads, batch.count, stats


class A3CTrainer:
    """Async-gradients trainer (Tune Trainable protocol like the other
    trainers)."""

    _default_config: Dict[str, Any] = {
        "env": None,
        "env_config": {},
        "num_workers": 2,
        "rollout_fragment_length": 64,
        "grads_per_iter": 16,   # applied gradients per train() call
        "policy_config": {},
        "seed": 0,
    }

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        self.config = dict(self._default_config)
        self.config.update(config or {})
        if env is not None:
            self.config["env"] = env
        if self.config["env"] is None:
            raise ValueError("config['env'] is required")
        if self.config["num_workers"] < 1:
            raise ValueError(
                "A3C's execution plan is inherently asynchronous over "
                "remote workers; num_workers must be >= 1 (use "
                "A2CTrainer for the synchronous local plan)")
        self._local_worker = _GradientWorker(
            self.config["env"], A2CPolicy,
            self.config.get("policy_config", {}),
            self.config.get("env_config", {}), worker_index=0)
        self.local_policy = self._local_worker.policy
        remote_cls = ray_tpu_torch.remote(num_cpus=0.5)(_GradientWorker)
        self.workers = [
            remote_cls.remote(self.config["env"], A2CPolicy,
                              self.config.get("policy_config", {}),
                              self.config.get("env_config", {}),
                              worker_index=i + 1)
            for i in range(self.config["num_workers"])]
        weights = ray_tpu_torch.put(self.local_policy.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self.workers])
        self._iteration = 0
        self._timesteps_total = 0
        self._grads_applied = 0

    # ------------------------------------------------------------- training
    def training_step(self) -> Dict[str, float]:
        frag = self.config["rollout_fragment_length"]
        in_flight = {w.sample_gradients.remote(frag): w
                     for w in self.workers}
        stats: Dict[str, float] = {}
        applied = 0
        while applied < self.config["grads_per_iter"]:
            # wait-any: apply whichever worker's gradients land first
            ready, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                    timeout=60)
            if not ready:
                break
            ref = ready[0]
            worker = in_flight.pop(ref)
            grads, count, stats = ray_tpu_torch.get([ref])[0]
            self.local_policy.apply_gradients(grads)
            self._timesteps_total += count
            applied += 1
            self._grads_applied += 1
            # fresh weights go back to THAT worker only; the others keep
            # sampling with their (slightly stale) copies
            worker.set_weights.remote(self.local_policy.get_weights())
            in_flight[worker.sample_gradients.remote(frag)] = worker
        # Drain stragglers in ONE bounded wait and USE their work —
        # computed gradients are not free; discarding them wastes a
        # fragment per worker per iteration.
        try:
            results = ray_tpu_torch.get(list(in_flight), timeout=120)
        except Exception as e:  # noqa: BLE001 — a wedged worker
            import logging

            logging.getLogger(__name__).warning(
                "a3c straggler drain failed: %r", e)
            results = []
        for grads, count, worker_stats in results:
            self.local_policy.apply_gradients(grads)
            self._timesteps_total += count
            self._grads_applied += 1
            stats = worker_stats
        return stats

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        stats = self.training_step()
        self._iteration += 1
        metrics = ray_tpu_torch.get([w.get_metrics.remote()
                               for w in self.workers])
        rewards = [m["episode_reward_mean"] for m in metrics
                   if not np.isnan(m["episode_reward_mean"])]
        return {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
            "grads_applied_total": self._grads_applied,
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "episodes_total": sum(m["episodes_total"] for m in metrics),
            "time_this_iter_s": time.perf_counter() - t0,
            "info": {"learner": stats},
        }

    # --------------------------------------------------------- Trainable
    def get_policy(self) -> A2CPolicy:
        return self.local_policy

    def compute_single_action(self, obs) -> int:
        actions, _ = self.local_policy.compute_actions(obs)
        return int(actions[0])

    def save_checkpoint(self) -> dict:
        return {"weights": self.local_policy.get_weights(),
                "iteration": self._iteration}

    def restore(self, checkpoint: dict) -> None:
        self.local_policy.set_weights(checkpoint["weights"])
        self._iteration = checkpoint["iteration"]
        weights = ray_tpu_torch.put(self.local_policy.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self.workers])

    def stop(self) -> None:
        for w in self.workers:
            ray_tpu_torch.kill(w)
        self.workers = []
