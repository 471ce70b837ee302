"""Trainers: PPOTrainer + DQNTrainer.

Reference: rllib/agents/trainer.py + agents/ppo/ppo.py, agents/dqn/dqn.py
*as API surface* — the execution plan here is the classic synchronous
loop: parallel rollouts on the worker fleet → concat → learn on the
local worker → broadcast weights. Trainers implement the Tune Trainable
protocol (train/save_checkpoint/restore) so `tune.run(PPOTrainer, ...)`
works unchanged.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Type

import numpy as np

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.policy import DQNPolicy, PPOPolicy, Policy
from ray_tpu_torch.rllib.rollout_worker import ReplayBuffer, WorkerSet
from ray_tpu_torch.rllib.sample_batch import SampleBatch

COMMON_CONFIG: Dict[str, Any] = {
    "env": None,
    "env_config": {},
    "num_workers": 2,
    "rollout_fragment_length": 200,
    "train_batch_size": 400,
    "seed": 0,
}


class Trainer:
    _policy_cls: Type[Policy] = None
    _default_config: Dict[str, Any] = COMMON_CONFIG

    def __init__(self, config: Optional[dict] = None,
                 env: Any = None):
        self.config = dict(self._default_config)
        self.config.update(config or {})
        if env is not None:
            self.config["env"] = env
        if self.config["env"] is None:
            raise ValueError("config['env'] is required")
        self.workers = WorkerSet(
            self.config["env"], self._policy_cls,
            num_workers=self.config["num_workers"],
            policy_config=self.config.get("policy_config", {}),
            env_config=self.config.get("env_config", {}))
        self.workers.sync_weights()
        self._iteration = 0
        self._timesteps_total = 0

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        learner_stats = self.training_step()
        self._iteration += 1
        metrics = self.workers.remote_metrics()
        rewards = [m["episode_reward_mean"] for m in metrics
                   if not np.isnan(m["episode_reward_mean"])]
        return {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "episodes_total": sum(m["episodes_total"] for m in metrics),
            "time_this_iter_s": time.perf_counter() - t0,
            "info": {"learner": learner_stats},
        }

    def training_step(self) -> Dict[str, float]:
        raise NotImplementedError

    # shared execution-plan pieces -------------------------------------
    def _per_worker(self, total_steps: int) -> int:
        return max(1, total_steps
                   // max(len(self.workers.remote_workers), 1))

    def _onpolicy_step(self, num_sgd_iter: int = 1,
                       per_fragment: bool = False) -> Dict[str, float]:
        """sample -> learn -> broadcast (the synchronous execution plan
        shared by PPO/A2C/IMPALA). per_fragment keeps worker fragments
        separate for algorithms whose math scans time within one
        trajectory (V-trace)."""
        per_worker = self._per_worker(self.config["train_batch_size"])
        stats: Dict[str, float] = {}
        if per_fragment:
            batches = self.workers.sample_parallel_batches(per_worker)
            for _ in range(num_sgd_iter):
                for fragment in batches:
                    stats = self.workers.local_worker.learn_on_batch(
                        fragment)
            self._timesteps_total += sum(b.count for b in batches)
        else:
            batch = self.workers.sample_parallel(per_worker)
            self._timesteps_total += batch.count
            for _ in range(num_sgd_iter):
                stats = self.workers.local_worker.learn_on_batch(batch)
        self.workers.sync_weights()
        return stats

    def _replay_step(self) -> Dict[str, float]:
        """store -> sample -> train (the replay execution plan shared by
        DQN/SAC)."""
        per_worker = self._per_worker(
            self.config["rollout_fragment_length"])
        batch = self.workers.sample_parallel(per_worker)
        self._timesteps_total += batch.count
        self.replay.add_batch(batch)
        stats: Dict[str, float] = {}
        if len(self.replay) >= self.config["learning_starts"]:
            for _ in range(self.config["sgd_steps_per_iter"]):
                stats = self.workers.local_worker.learn_on_batch(
                    self.replay.sample(self.config["sgd_batch_size"]))
            self.workers.sync_weights()
        return stats

    # ----------------------------------------------- tune Trainable shims
    def save_checkpoint(self) -> dict:
        return {"weights": self.workers.local_worker.get_weights(),
                "iteration": self._iteration}

    def restore(self, checkpoint: dict) -> None:
        self.workers.local_worker.set_weights(checkpoint["weights"])
        self._iteration = checkpoint["iteration"]
        self.workers.sync_weights()

    def get_policy(self) -> Policy:
        return self.workers.local_worker.policy

    def compute_single_action(self, obs) -> int:
        actions, _ = self.get_policy().compute_actions(obs)
        return int(actions[0])

    def stop(self) -> None:
        self.workers.stop()


class PPOTrainer(Trainer):
    _policy_cls = PPOPolicy
    _default_config = {**COMMON_CONFIG, "policy_config": {}}

    def training_step(self) -> Dict[str, float]:
        return self._onpolicy_step()


class A2CTrainer(Trainer):
    """Synchronous advantage actor-critic (reference: agents/a3c run in
    its synchronous configuration)."""

    _policy_cls = None  # set below (import ordering)
    _default_config = {**COMMON_CONFIG, "policy_config": {}}

    def training_step(self) -> Dict[str, float]:
        return self._onpolicy_step()


class IMPALATrainer(Trainer):
    """Importance-weighted actor-learner: the fleet keeps sampling with
    the weights it has (stale by up to one sync) and V-trace corrects
    at the learner (reference: agents/impala/impala.py). Weights
    broadcast once per iteration, not per batch, so sampling and
    learning overlap."""

    _policy_cls = None
    _default_config = {**COMMON_CONFIG, "policy_config": {},
                      "num_sgd_iter": 2}

    def training_step(self) -> Dict[str, float]:
        # per_fragment: V-trace scans time within a fragment; gluing two
        # workers' unrelated fragments would leak corrections across the
        # boundary
        return self._onpolicy_step(self.config["num_sgd_iter"],
                                   per_fragment=True)


class APPOTrainer(IMPALATrainer):
    """Asynchronous PPO (reference: agents/ppo/appo.py): IMPALA's
    execution plan — stale-weight fleet sampling, periodic broadcast —
    with the PPO clipped-surrogate loss over V-trace advantages
    (policy_extra.APPOPolicy)."""


class SACTrainer(Trainer):
    """Discrete soft actor-critic over a replay buffer (reference:
    agents/sac/sac.py execution plan: store -> sample -> train)."""

    _policy_cls = None
    _default_config = {
        **COMMON_CONFIG,
        "policy_config": {},
        "buffer_size": 50_000,
        "learning_starts": 500,
        "sgd_batch_size": 64,
        "sgd_steps_per_iter": 8,
    }

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        super().__init__(config, env)
        self.replay = ReplayBuffer(self.config["buffer_size"],
                                   self.config["seed"])

    def training_step(self) -> Dict[str, float]:
        return self._replay_step()


class DQNTrainer(Trainer):
    _policy_cls = DQNPolicy
    _default_config = {
        **COMMON_CONFIG,
        "policy_config": {},
        "buffer_size": 50_000,
        "learning_starts": 500,
        "sgd_batch_size": 64,
        "sgd_steps_per_iter": 16,
    }

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        super().__init__(config, env)
        self.replay = ReplayBuffer(self.config["buffer_size"],
                                   self.config["seed"])

    def training_step(self) -> Dict[str, float]:
        return self._replay_step()


class PGTrainer(Trainer):
    """Vanilla policy gradient (reference: agents/pg/pg.py)."""

    _policy_cls = None
    _default_config = {**COMMON_CONFIG, "policy_config": {}}

    def training_step(self) -> Dict[str, float]:
        return self._onpolicy_step()


class DDPGTrainer(Trainer):
    """Continuous control over a replay buffer (reference:
    agents/ddpg/ddpg.py)."""

    _policy_cls = None
    _default_config = {
        **COMMON_CONFIG,
        "policy_config": {},
        "buffer_size": 50_000,
        "learning_starts": 500,
        "sgd_batch_size": 64,
        "sgd_steps_per_iter": 8,
    }

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        super().__init__(config, env)
        self.replay = ReplayBuffer(self.config["buffer_size"],
                                   self.config["seed"])

    def training_step(self) -> Dict[str, float]:
        return self._replay_step()


class TD3Trainer(DDPGTrainer):
    """reference: agents/ddpg/td3.py"""

    _policy_cls = None


class SACContinuousTrainer(DDPGTrainer):
    """Continuous soft actor-critic over the replay plan (reference:
    agents/sac/sac.py — the continuous configuration; the discrete
    variant is SACTrainer)."""

    _policy_cls = None


class LinUCBTrainer(Trainer):
    """Contextual bandit, UCB exploration (reference:
    agents/bandit/bandit.py BanditLinUCBTrainer)."""

    _policy_cls = None
    _default_config = {**COMMON_CONFIG, "policy_config": {},
                       "rollout_fragment_length": 32,
                       "train_batch_size": 64}

    def training_step(self) -> Dict[str, float]:
        return self._onpolicy_step()


class LinTSTrainer(LinUCBTrainer):
    """reference: agents/bandit/bandit.py BanditLinTSTrainer"""

    _policy_cls = None


class MARWILTrainer(Trainer):
    """Offline RL: learns from a recorded experience file/batches, with
    on-policy evaluation through the worker fleet (reference:
    agents/marwil/marwil.py; config['input'] like rllib's offline input
    API). BC is the beta=0 special case."""

    _policy_cls = None
    _default_config = {
        **COMMON_CONFIG,
        "policy_config": {},
        "input": None,            # path to JSON lines or list of batches
        "sgd_steps_per_iter": 16,
        "evaluation_num_steps": 200,
    }

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        super().__init__(config, env)
        from ray_tpu_torch.rllib.offline import JsonReader

        if self.config["input"] is None:
            raise ValueError("offline trainers need config['input']")
        self.reader = JsonReader(self.config["input"])

    def training_step(self) -> Dict[str, float]:
        stats: Dict[str, float] = {}
        local = self.workers.local_worker
        for _ in range(self.config["sgd_steps_per_iter"]):
            batch = local.policy.postprocess_trajectory(self.reader.next())
            stats = local.learn_on_batch(batch)
            self._timesteps_total += batch.count
        self.workers.sync_weights()
        # on-policy evaluation drives the reward metric
        self.workers.sample_parallel(
            self._per_worker(self.config["evaluation_num_steps"]))
        return stats


class CQLTrainer(Trainer):
    """Offline continuous RL: conservative Q-learning over a recorded
    dataset (reference: agents/cql/cql.py — config['input'] like the
    offline API, SAC-style policy underneath). Evaluation is on-policy
    through the worker fleet."""

    _policy_cls = None
    _default_config = {
        **COMMON_CONFIG,
        "policy_config": {},
        "input": None,
        "sgd_batch_size": 64,
        "sgd_steps_per_iter": 32,
        "evaluation_num_steps": 200,
    }

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        super().__init__(config, env)
        from ray_tpu_torch.rllib.offline import JsonReader

        if self.config["input"] is None:
            raise ValueError("offline trainers need config['input']")
        reader = JsonReader(self.config["input"])
        # one dataset-wide replay pool sampled in minibatches
        self.replay = ReplayBuffer(
            capacity=sum(b.count for b in reader.batches),
            seed=self.config["seed"])
        for b in reader.batches:
            self.replay.add_batch(b)

    def training_step(self) -> Dict[str, float]:
        stats: Dict[str, float] = {}
        local = self.workers.local_worker
        for _ in range(self.config["sgd_steps_per_iter"]):
            stats = local.learn_on_batch(
                self.replay.sample(self.config["sgd_batch_size"]))
        self._timesteps_total += (self.config["sgd_steps_per_iter"]
                                  * self.config["sgd_batch_size"])
        self.workers.sync_weights()
        # on-policy evaluation drives the reward metric
        self.workers.sample_parallel(
            self._per_worker(self.config["evaluation_num_steps"]))
        return stats


class BCTrainer(MARWILTrainer):
    """Behavior cloning = MARWIL with beta=0 (reference:
    agents/marwil/bc.py)."""

    _policy_cls = None

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        config = dict(config or {})
        pc = dict(config.get("policy_config", {}))
        pc["beta"] = 0.0
        config["policy_config"] = pc
        super().__init__(config, env)


# late binding: policy modules import Policy helpers from policy.py
from ray_tpu_torch.rllib.policy_bandit import (  # noqa: E402
    LinTSPolicy,
    LinUCBPolicy,
)
from ray_tpu_torch.rllib.policy_continuous import (  # noqa: E402
    ContinuousSACPolicy,
    CQLPolicy,
    DDPGPolicy,
    TD3Policy,
)
from ray_tpu_torch.rllib.policy_extra import (  # noqa: E402
    A2CPolicy,
    APPOPolicy,
    IMPALAPolicy,
    SACPolicy,
)
from ray_tpu_torch.rllib.policy_pg import (  # noqa: E402
    MARWILPolicy,
    PGPolicy,
)

A2CTrainer._policy_cls = A2CPolicy
IMPALATrainer._policy_cls = IMPALAPolicy
APPOTrainer._policy_cls = APPOPolicy
SACTrainer._policy_cls = SACPolicy
PGTrainer._policy_cls = PGPolicy
MARWILTrainer._policy_cls = MARWILPolicy
BCTrainer._policy_cls = MARWILPolicy
DDPGTrainer._policy_cls = DDPGPolicy
TD3Trainer._policy_cls = TD3Policy
SACContinuousTrainer._policy_cls = ContinuousSACPolicy
CQLTrainer._policy_cls = CQLPolicy
LinUCBTrainer._policy_cls = LinUCBPolicy
LinTSTrainer._policy_cls = LinTSPolicy
