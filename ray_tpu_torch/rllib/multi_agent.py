"""Multi-agent RL: MultiAgentEnv + policy mapping + trainer.

Reference behavior: rllib's multi-agent API (rllib/env/multi_agent_env.py,
the `multiagent` config of trainer.py: `policies` dict +
`policy_mapping_fn`, per-policy SampleBatches, independent or shared
policies). The env speaks dicts keyed by agent id; "__all__" in the done
dict ends the episode.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class MultiAgentEnv:
    """Dict-keyed env API (reference: rllib/env/multi_agent_env.py)."""

    agent_ids: Tuple[str, ...] = ()
    observation_dim: int = 0
    num_actions: int = 0

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]) -> Tuple[
            Dict[str, np.ndarray], Dict[str, float], Dict[str, bool],
            Dict[str, dict]]:
        raise NotImplementedError

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)


class TwoStepGuessEnv(MultiAgentEnv):
    """Two agents, each shown its own one-hot target; reward 1 for
    matching it, plus a 0.5 team bonus when BOTH match — learnable in
    seconds, with a cooperative component (the multi-agent analogue of
    StatelessGuessEnv)."""

    agent_ids = ("a0", "a1")

    def __init__(self, num_actions: int = 3, seed: Optional[int] = None):
        self.num_actions = num_actions
        self.observation_dim = num_actions
        self._rng = np.random.default_rng(seed)
        self._targets: Dict[str, int] = {}

    def reset(self) -> Dict[str, np.ndarray]:
        obs = {}
        for aid in self.agent_ids:
            t = int(self._rng.integers(self.num_actions))
            self._targets[aid] = t
            one_hot = np.zeros(self.num_actions, np.float32)
            one_hot[t] = 1.0
            obs[aid] = one_hot
        return obs

    def step(self, actions: Dict[str, int]):
        hits = {aid: int(actions[aid]) == self._targets[aid]
                for aid in self.agent_ids}
        bonus = 0.5 if all(hits.values()) else 0.0
        rewards = {aid: (1.0 if hits[aid] else 0.0) + bonus
                   for aid in self.agent_ids}
        dones = {aid: True for aid in self.agent_ids}
        dones["__all__"] = True
        return self.reset(), rewards, dones, {aid: {} for aid
                                              in self.agent_ids}


class MultiAgentRolloutWorker:
    """Env + a policy map; produces one SampleBatch PER POLICY, each
    postprocessed by its own policy (reference:
    rllib/evaluation/sampler.py multi-agent episode collection)."""

    def __init__(self, env: Any, policies: Dict[str, tuple],
                 policy_mapping_fn: Callable[[str], str],
                 env_config: Optional[dict] = None,
                 worker_index: int = 0):
        self.env = env(**(env_config or {})) if isinstance(env, type) \
            else env
        self.policy_mapping_fn = policy_mapping_fn
        self.policies: Dict[str, Any] = {}
        for pid, (cls, cfg) in policies.items():
            cfg = dict(cfg or {})
            cfg["seed"] = cfg.get("seed", 0) + worker_index * 1000
            self.policies[pid] = cls(self.env.observation_dim,
                                     self.env.num_actions, cfg)
        self._obs = self.env.reset()
        self._episode_reward = 0.0
        self.episode_rewards: List[float] = []

    def sample(self, num_steps: int) -> Dict[str, SampleBatch]:
        # Transitions accumulate PER AGENT so each agent's rows form one
        # contiguous trajectory; interleaving two agents' rows into a
        # single stream would let return-to-go/GAE postprocessing
        # bootstrap one agent's advantages from the other's rewards
        # (reference: per-agent episode collection in
        # rllib/evaluation/sampler.py).
        cols: Dict[str, Dict[str, list]] = {}  # agent_id -> columns
        for _ in range(num_steps):
            actions: Dict[str, int] = {}
            extras_by_agent: Dict[str, dict] = {}
            for aid, obs in self._obs.items():
                pid = self.policy_mapping_fn(aid)
                acts, extras = self.policies[pid].compute_actions(obs)
                actions[aid] = int(acts[0])
                extras_by_agent[aid] = extras
            next_obs, rewards, dones, _ = self.env.step(actions)
            for aid, obs in self._obs.items():
                c = cols.setdefault(aid, {})
                c.setdefault(sb.OBS, []).append(obs)
                c.setdefault(sb.ACTIONS, []).append(actions[aid])
                c.setdefault(sb.REWARDS, []).append(rewards[aid])
                c.setdefault(sb.DONES, []).append(dones.get(aid, False))
                c.setdefault(sb.NEXT_OBS, []).append(
                    next_obs.get(aid, obs))
                for k, v in extras_by_agent[aid].items():
                    c.setdefault(k, []).append(np.asarray(v)[0])
            self._episode_reward += float(np.mean(list(rewards.values())))
            if dones.get("__all__", False):
                self.episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs = self.env.reset()
            else:
                self._obs = next_obs
        per_policy: Dict[str, List[SampleBatch]] = {}
        for aid, c in cols.items():
            pid = self.policy_mapping_fn(aid)
            batch = SampleBatch({k: np.asarray(v) for k, v in c.items()})
            per_policy.setdefault(pid, []).append(
                self.policies[pid].postprocess_trajectory(batch))
        return {pid: SampleBatch.concat_samples(parts)
                for pid, parts in per_policy.items()}

    def learn_on_batches(self, batches: Dict[str, SampleBatch]
                         ) -> Dict[str, Dict[str, float]]:
        return {pid: self.policies[pid].learn_on_batch(batch)
                for pid, batch in batches.items()}

    def get_weights(self) -> Dict[str, Any]:
        return {pid: p.get_weights() for pid, p in self.policies.items()}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)

    def get_metrics(self) -> Dict[str, Any]:
        rewards = self.episode_rewards[-100:]
        return {
            "episodes_total": len(self.episode_rewards),
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
        }


class MultiAgentTrainer:
    """Synchronous multi-agent on-policy loop: parallel dict-of-batches
    rollouts -> per-policy learn on the local worker -> broadcast
    (reference: trainer.py multiagent config + the standard execution
    plan)."""

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        cfg = {
            "env": None,
            "env_config": {},
            "num_workers": 2,
            "train_batch_size": 256,
            "policies": None,           # {policy_id: (policy_cls, cfg)}
            "policy_mapping_fn": None,  # agent_id -> policy_id
            "seed": 0,
        }
        cfg.update(config or {})
        if env is not None:
            cfg["env"] = env
        if cfg["env"] is None or not cfg["policies"]:
            raise ValueError("env and policies are required")
        if cfg["policy_mapping_fn"] is None:
            if len(cfg["policies"]) > 1:
                # silently routing every agent to one of several
                # configured policies would leave the rest untrained
                raise ValueError(
                    "policy_mapping_fn is required when more than one "
                    "policy is configured")
            first = next(iter(cfg["policies"]))
            cfg["policy_mapping_fn"] = lambda aid: first
        self.config = cfg
        self.local_worker = MultiAgentRolloutWorker(
            cfg["env"], cfg["policies"], cfg["policy_mapping_fn"],
            cfg["env_config"], worker_index=0)
        remote_cls = ray_tpu_torch.remote(num_cpus=0.5)(MultiAgentRolloutWorker)
        self.remote_workers = [
            remote_cls.remote(cfg["env"], cfg["policies"],
                              cfg["policy_mapping_fn"], cfg["env_config"],
                              worker_index=i + 1)
            for i in range(cfg["num_workers"])]
        self._sync()
        self._iteration = 0
        self._timesteps_total = 0

    def _sync(self) -> None:
        weights = ray_tpu_torch.put(self.local_worker.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(weights)
                     for w in self.remote_workers])

    def train(self) -> Dict[str, Any]:
        per_worker = max(1, self.config["train_batch_size"]
                         // max(len(self.remote_workers), 1))
        dicts = ray_tpu_torch.get([w.sample.remote(per_worker)
                             for w in self.remote_workers]) \
            if self.remote_workers else [self.local_worker.sample(
                per_worker)]
        merged: Dict[str, List[SampleBatch]] = {}
        for d in dicts:
            for pid, batch in d.items():
                merged.setdefault(pid, []).append(batch)
        batches = {pid: SampleBatch.concat_samples(parts)
                   for pid, parts in merged.items()}
        self._timesteps_total += sum(b.count for b in batches.values())
        stats = self.local_worker.learn_on_batches(batches)
        self._sync()
        self._iteration += 1
        metrics = ray_tpu_torch.get([w.get_metrics.remote()
                               for w in self.remote_workers]) \
            if self.remote_workers else [self.local_worker.get_metrics()]
        rewards = [m["episode_reward_mean"] for m in metrics
                   if not np.isnan(m["episode_reward_mean"])]
        return {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "info": {"learner": stats},
        }

    def get_policy(self, policy_id: str):
        return self.local_worker.policies[policy_id]

    def save_checkpoint(self) -> dict:
        return {"weights": self.local_worker.get_weights(),
                "iteration": self._iteration}

    def restore(self, checkpoint: dict) -> None:
        self.local_worker.set_weights(checkpoint["weights"])
        self._iteration = checkpoint["iteration"]
        self._sync()

    def stop(self) -> None:
        for w in self.remote_workers:
            ray_tpu_torch.kill(w)
        self.remote_workers = []
