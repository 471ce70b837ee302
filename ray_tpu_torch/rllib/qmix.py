"""QMIX / VDN: cooperative multi-agent Q-learning with value
decomposition.

Reference behavior: rllib/agents/qmix/ (QMixTrainer, qmix_policy.py's
monotonic mixing network over agent Qs + global state; VDN is the
additive special case). Port of ray_tpu/rllib/qmix.py: the agent Q-net
and the mixer's hypernets are policy.py's MLPs over parameter trees in
the JAX package's layout, with one adam and a hard target sync, on the
device of ``config["device"]`` (CUDA unless the caller asks for the
CPU); the joint replay and the epsilon-greedy exploration stay numpy.

The team trains on JOINT transitions (every agent's obs/action plus the
shared reward), so this trainer samples its own joint replay buffer
rather than the per-policy batches of MultiAgentTrainer.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.multi_agent import MultiAgentEnv
from ray_tpu_torch.rllib.policy import (
    Adam,
    adam_step,
    init_mlp,
    mlp_apply,
    take,
    tree_clone,
    tree_to_device,
    tree_to_numpy,
)


class TwoStepCoopEnv(MultiAgentEnv):
    """The QMIX paper's two-step cooperative game: agent a0's first
    action selects the second-step payoff matrix; in state 2 the optimal
    joint action pays 8 but miscoordination pays 0/1 — independent
    learners settle for the safe 7, value decomposition finds 8."""

    agent_ids = ("a0", "a1")
    observation_dim = 3  # one-hot state id
    num_actions = 2

    def __init__(self, seed: Optional[int] = None):
        # the game is fully deterministic; seed accepted for registry
        # compatibility with the other envs' constructors
        del seed
        self._state = 0

    def _obs(self) -> Dict[str, np.ndarray]:
        one_hot = np.zeros(3, np.float32)
        one_hot[self._state] = 1.0
        return {aid: one_hot.copy() for aid in self.agent_ids}

    def reset(self) -> Dict[str, np.ndarray]:
        self._state = 0
        return self._obs()

    def step(self, actions: Dict[str, int]):
        if self._state == 0:
            self._state = 1 if int(actions["a0"]) == 0 else 2
            rewards = {aid: 0.0 for aid in self.agent_ids}
            dones = {aid: False for aid in self.agent_ids}
            dones["__all__"] = False
            return self._obs(), rewards, dones, {a: {} for a
                                                 in self.agent_ids}
        if self._state == 1:
            team = 7.0
        else:  # state 2: [[0, 1], [1, 8]]
            matrix = ((0.0, 1.0), (1.0, 8.0))
            team = matrix[int(actions["a0"])][int(actions["a1"])]
        rewards = {aid: team for aid in self.agent_ids}
        dones = {aid: True for aid in self.agent_ids}
        dones["__all__"] = True
        return self.reset(), rewards, dones, {a: {} for a
                                              in self.agent_ids}


class _JointReplay:
    """FIFO replay of joint transitions, rows of
    (obs[n_agents], actions[n_agents], team_reward, done, next_obs);
    the global state is derived at sample time by flattening obs."""

    def __init__(self, capacity: int, seed: int):
        self.capacity = capacity
        self._rows: List[tuple] = []
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def add(self, row: tuple) -> None:
        if len(self._rows) < self.capacity:
            self._rows.append(row)
        else:
            self._rows[self._next] = row
        self._next = (self._next + 1) % self.capacity

    def __len__(self) -> int:
        return len(self._rows)

    def sample(self, n: int) -> List[tuple]:
        idx = self._rng.integers(len(self._rows), size=n)
        return [self._rows[i] for i in idx]


class QMixTrainer:
    """Centralized training, decentralized execution. config['mixer']:
    'qmix' (monotonic state-conditioned mixer, the default) or 'vdn'
    (plain sum — reference: qmix.py's mixer config)."""

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        cfg = {
            "env": None,
            "env_config": {},
            "mixer": "qmix",
            "lr": 5e-3,
            "gamma": 0.99,
            "hidden": (32,),
            "mixer_hidden": 16,
            "buffer_size": 5000,
            "sgd_batch_size": 64,
            "sgd_steps_per_iter": 32,
            "rollout_steps_per_iter": 128,
            "target_update_freq": 50,
            "epsilon": 1.0,
            "epsilon_min": 0.05,
            "epsilon_decay": 0.995,
            "seed": 0,
            "device": None,
        }
        cfg.update(config or {})
        if env is not None:
            cfg["env"] = env
        if cfg["env"] is None:
            raise ValueError("config['env'] is required")
        self.config = cfg
        self.device = resolve_device(cfg["device"])
        env_cls = cfg["env"]
        self.env: MultiAgentEnv = (
            env_cls(**cfg["env_config"]) if isinstance(env_cls, type)
            else env_cls)
        self.agent_ids = tuple(self.env.agent_ids)
        self.n_agents = len(self.agent_ids)
        obs_dim = self.env.observation_dim
        self.n_actions = self.env.num_actions
        state_dim = obs_dim * self.n_agents
        hidden = tuple(cfg["hidden"])
        mh = cfg["mixer_hidden"]
        gen = torch.Generator().manual_seed(int(cfg["seed"]))
        # one shared per-agent Q network (parameter sharing, the
        # reference default) + the state-conditioned mixer hypernet
        self.params = {
            name: init_mlp(gen, sizes, self.device) for name, sizes in (
                ("q", (obs_dim, *hidden, self.n_actions)),
                ("hyper_w1", (state_dim, self.n_agents * mh)),
                ("hyper_b1", (state_dim, mh)),
                ("hyper_w2", (state_dim, mh)),
                ("hyper_b2", (state_dim, 1)))}
        self.target = tree_clone(self.params)
        self.opt = Adam(cfg["lr"])
        self.opt_state = self.opt.init(self.params)
        self._rng = np.random.default_rng(cfg["seed"])
        self.replay = _JointReplay(cfg["buffer_size"], cfg["seed"])
        self.epsilon = cfg["epsilon"]
        self._updates = 0
        self._iteration = 0
        self.episode_rewards: List[float] = []
        self._rollout_obs: Optional[Dict[str, np.ndarray]] = None
        self._ep_reward = 0.0

    def mix(self, params, agent_qs: torch.Tensor,
            state: torch.Tensor) -> torch.Tensor:
        """Monotonic mixing: abs() on hypernet weights keeps
        dQ_tot/dQ_i >= 0 (reference: qmix_policy.py Mixer)."""
        if self.config["mixer"] == "vdn":
            return torch.sum(agent_qs, dim=-1)              # [B]
        b, mh = agent_qs.shape[0], self.config["mixer_hidden"]
        w1 = torch.abs(mlp_apply(params["hyper_w1"], state)).reshape(
            b, self.n_agents, mh)
        b1 = mlp_apply(params["hyper_b1"], state)            # [B, mh]
        hidden_q = F.elu(torch.einsum("ba,bam->bm", agent_qs, w1) + b1)
        w2 = torch.abs(mlp_apply(params["hyper_w2"], state))  # [B, mh]
        b2 = mlp_apply(params["hyper_b2"], state)[..., 0]     # [B]
        return torch.einsum("bm,bm->b", hidden_q, w2) + b2

    def td_loss(self, params, obs, actions, rewards, dones, next_obs):
        """The TD loss of one joint batch: obs/next_obs [B, N, obs],
        actions [B, N] int64, rewards/dones [B]; the global state is
        the flattened obs."""
        state = obs.reshape(obs.shape[0], -1)
        next_state = next_obs.reshape(next_obs.shape[0], -1)
        with torch.no_grad():  # target params: constant w.r.t. the grads
            best_next = torch.max(mlp_apply(self.target["q"], next_obs),
                                  dim=-1).values                # [B,N]
            y = rewards + self.config["gamma"] * (1.0 - dones) * self.mix(
                self.target, best_next, next_state)
        chosen = take(mlp_apply(params["q"], obs), actions)    # [B,N]
        q_tot = self.mix(params, chosen, state)                # [B]
        return torch.mean((q_tot - y) ** 2)

    # ------------------------------------------------------------ rollouts
    def _act(self, obs: Dict[str, np.ndarray]) -> Dict[str, int]:
        out = self.greedy_actions(obs)
        for aid in self.agent_ids:  # epsilon-greedy over the greedy base
            if self._rng.random() < self.epsilon:
                out[aid] = int(self._rng.integers(self.n_actions))
        return out

    def _rollout(self, steps: int) -> None:
        # episode state persists ACROSS training steps: an env whose
        # episodes outlast one rollout window must keep its in-flight
        # episode (and its reward tally), not abandon it at a reset
        if self._rollout_obs is None:
            self._rollout_obs = self.env.reset()
        obs = self._rollout_obs
        for _ in range(steps):
            actions = self._act(obs)
            next_obs, rewards, dones, _ = self.env.step(actions)
            team = float(np.mean(list(rewards.values())))
            self._ep_reward += team
            done = bool(dones.get("__all__", False))
            self.replay.add((
                np.stack([obs[a] for a in self.agent_ids]),
                np.array([actions[a] for a in self.agent_ids], np.int32),
                team, float(done),
                np.stack([next_obs[a] for a in self.agent_ids]),
            ))
            if done:
                self.episode_rewards.append(self._ep_reward)
                self._ep_reward = 0.0
                obs = self.env.reset()
            else:
                obs = next_obs
            self.epsilon = max(self.config["epsilon_min"],
                               self.epsilon * self.config["epsilon_decay"])
        self._rollout_obs = obs

    # ------------------------------------------------------------- training
    def _tensors(self, rows: List[tuple]) -> tuple:
        dev = self.device

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return (f32(np.stack([r[0] for r in rows])),
                torch.as_tensor(np.stack([r[1] for r in rows]).astype(
                    np.int64), device=dev),
                f32([r[2] for r in rows]), f32([r[3] for r in rows]),
                f32(np.stack([r[4] for r in rows])))

    def training_step(self) -> Dict[str, float]:
        self._rollout(self.config["rollout_steps_per_iter"])
        if len(self.replay) < self.config["sgd_batch_size"]:
            return {}
        loss = torch.zeros(())
        for _ in range(self.config["sgd_steps_per_iter"]):
            rows = self.replay.sample(self.config["sgd_batch_size"])
            loss = self.td_loss(self.params, *self._tensors(rows))
            adam_step(self.opt, self.opt_state, self.params, loss)
            self._updates += 1
            if self._updates % self.config["target_update_freq"] == 0:
                self.target = tree_clone(self.params)
        return {"td_loss": float(loss.detach()), "epsilon": self.epsilon}

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        stats = self.training_step()
        self._iteration += 1
        rewards = self.episode_rewards[-100:]
        return {
            "training_iteration": self._iteration,
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "time_this_iter_s": time.perf_counter() - t0,
            "info": {"learner": stats},
        }

    @torch.no_grad()
    def greedy_actions(self, obs: Dict[str, np.ndarray]) -> Dict[str, int]:
        stacked = torch.as_tensor(
            np.stack([obs[a] for a in self.agent_ids]).astype(np.float32),
            device=self.device)
        greedy = torch.argmax(mlp_apply(self.params["q"], stacked),
                              dim=-1).cpu().numpy()
        return {aid: int(greedy[i])
                for i, aid in enumerate(self.agent_ids)}

    def save_checkpoint(self) -> dict:
        return {"params": tree_to_numpy(self.params),
                "iteration": self._iteration}

    def restore(self, checkpoint: dict) -> None:
        self.params = tree_to_device(checkpoint["params"], self.device)
        self.target = tree_clone(self.params)
        self._iteration = checkpoint["iteration"]

    def stop(self) -> None:
        pass


class VDNTrainer(QMixTrainer):
    """Additive value decomposition (reference: mixer='vdn')."""

    def __init__(self, config: Optional[dict] = None, env: Any = None):
        config = dict(config or {})
        config["mixer"] = "vdn"
        super().__init__(config, env)
