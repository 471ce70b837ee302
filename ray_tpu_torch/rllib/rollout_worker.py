"""RolloutWorker + WorkerSet + ReplayBuffer.

Reference: rllib/evaluation/rollout_worker.py (env+policy pair that
produces SampleBatches), worker_set.py (local learner + remote actor
fleet), execution/replay_ops.py (replay buffer).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class RolloutWorker:
    def __init__(self, env: Any, policy_cls, policy_config: Optional[dict]
                 = None, env_config: Optional[dict] = None,
                 worker_index: int = 0):
        self.env = make_env(env, env_config)
        cfg = dict(policy_config or {})
        cfg["seed"] = cfg.get("seed", 0) + worker_index * 1000
        self._continuous = bool(getattr(self.env, "action_dim", 0))
        if self._continuous:  # bounds flow env -> policy config
            cfg.setdefault("action_low", self.env.action_low)
            cfg.setdefault("action_high", self.env.action_high)
            self.policy = policy_cls(self.env.observation_dim,
                                     self.env.action_dim, cfg)
        else:
            self.policy = policy_cls(self.env.observation_dim,
                                     self.env.num_actions, cfg)
        self.worker_index = worker_index
        self._obs = self.env.reset()
        self._episode_reward = 0.0
        self._episode_len = 0
        self.episode_rewards: List[float] = []
        self.episode_lengths: List[int] = []

    def sample(self, num_steps: int) -> SampleBatch:
        cols: Dict[str, list] = {k: [] for k in (
            sb.OBS, sb.ACTIONS, sb.REWARDS, sb.DONES, sb.NEXT_OBS)}
        extra_cols: Dict[str, list] = {}
        for _ in range(num_steps):
            actions, extras = self.policy.compute_actions(self._obs)
            if self._continuous:
                action = np.asarray(actions[0], np.float32)
            else:
                action = int(actions[0])
            next_obs, reward, done, _ = self.env.step(action)
            cols[sb.OBS].append(self._obs)
            cols[sb.ACTIONS].append(action)
            cols[sb.REWARDS].append(reward)
            cols[sb.DONES].append(done)
            cols[sb.NEXT_OBS].append(next_obs)
            for k, v in extras.items():
                extra_cols.setdefault(k, []).append(np.asarray(v)[0])
            self._episode_reward += reward
            self._episode_len += 1
            if done:
                self.episode_rewards.append(self._episode_reward)
                self.episode_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                self._obs = self.env.reset()
            else:
                self._obs = next_obs
        batch = SampleBatch(
            {k: np.asarray(v) for k, v in {**cols, **extra_cols}.items()})
        return self.policy.postprocess_trajectory(batch)

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        return self.policy.learn_on_batch(batch)

    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def get_metrics(self) -> Dict[str, Any]:
        rewards = self.episode_rewards[-100:]
        lengths = self.episode_lengths[-100:]
        return {
            "episodes_total": len(self.episode_rewards),
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "episode_len_mean": float(np.mean(lengths)) if lengths
            else float("nan"),
        }


class WorkerSet:
    """Local learner worker + remote sampler actors (reference:
    rllib/evaluation/worker_set.py)."""

    def __init__(self, env: Any, policy_cls, num_workers: int = 2,
                 policy_config: Optional[dict] = None,
                 env_config: Optional[dict] = None,
                 remote_args: Optional[dict] = None):
        self.local_worker = RolloutWorker(env, policy_cls, policy_config,
                                          env_config, worker_index=0)
        remote_cls = ray_tpu_torch.remote(**(remote_args or {"num_cpus": 0.5}))(
            RolloutWorker)
        self.remote_workers = [
            remote_cls.remote(env, policy_cls, policy_config, env_config,
                              worker_index=i + 1)
            for i in range(num_workers)]

    def sample_parallel(self, steps_per_worker: int) -> SampleBatch:
        return SampleBatch.concat_samples(
            self.sample_parallel_batches(steps_per_worker))

    def sample_parallel_batches(self, steps_per_worker: int
                                ) -> list:
        """Per-worker fragments, NOT concatenated — algorithms whose math
        scans over time within a trajectory (V-trace) must not see two
        unrelated fragments glued together."""
        if not self.remote_workers:
            return [self.local_worker.sample(steps_per_worker)]
        return ray_tpu_torch.get([w.sample.remote(steps_per_worker)
                            for w in self.remote_workers])

    def sync_weights(self) -> None:
        weights = ray_tpu_torch.put(self.local_worker.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(weights)
                     for w in self.remote_workers])

    def remote_metrics(self) -> List[Dict[str, Any]]:
        if not self.remote_workers:
            return [self.local_worker.get_metrics()]
        return ray_tpu_torch.get([w.get_metrics.remote()
                            for w in self.remote_workers])

    def stop(self) -> None:
        for w in self.remote_workers:
            ray_tpu_torch.kill(w)
        self.remote_workers = []


class ReplayBuffer:
    """Uniform FIFO replay (reference: rllib/execution/replay_buffer.py)."""

    def __init__(self, capacity: int = 50_000, seed: int = 0):
        self.capacity = capacity
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def add_batch(self, batch: SampleBatch) -> None:
        n = batch.count
        if n == 0:
            return
        if self._cols is None:
            self._cols = {
                k: np.zeros((self.capacity,) + np.asarray(v).shape[1:],
                            dtype=np.asarray(v).dtype)
                for k, v in batch.items()}
        for k, v in batch.items():
            v = np.asarray(v)
            idx = (self._next + np.arange(n)) % self.capacity
            self._cols[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def __len__(self) -> int:
        return self._size

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(self._size, size=batch_size)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})
