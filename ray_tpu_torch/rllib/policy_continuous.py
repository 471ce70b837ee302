"""Continuous-control PyTorch policies: DDPG, TD3, continuous SAC and
CQL.

Port of ray_tpu/rllib/policy_continuous.py (reference behavior:
rllib/agents/ddpg/ (DDPG + the TD3 configuration: twin critics, delayed
policy updates, target policy smoothing — ddpg/ddpg_tf_policy.py
build_ddpg_models + td3.py), agents/sac/ (continuous) and agents/cql/).
The parameter trees, device rule and optimizer are policy.py's; polyak
target averaging keeps the JAX package's arithmetic.

Randomness: DDPG/TD3's exploration and target noise is numpy, draw for
draw as in the JAX package. Continuous SAC's reparameterisation noise
and CQL's random actions come from a ``torch.Generator`` seeded with
``cfg["seed"] + 1`` on the policy's device (the JAX package draws them
with ``jax.random`` from ``PRNGKey(seed + 1)``); ``learn_on_batch``
takes them as tensors (``noise=``) when the caller has its own.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.policy import (
    Adam,
    Policy,
    _setup,
    grads_of,
    init_mlp,
    mlp_apply,
    polyak_,
    scalars,
    tree_clone,
    tree_leaves,
    tree_to_device,
    tree_to_numpy,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _q(params, name: str, obs, act):
    return mlp_apply(params[name], torch.cat([obs, act], dim=1))[..., 0]


def _detached(params):
    """``jax.lax.stop_gradient(params)``: the same values, no grad."""
    return {k: [{n: t.detach() for n, t in layer.items()} for layer in v]
            if isinstance(v, list) else v.detach()
            for k, v in params.items()}


def _grouped_step(groups, params, loss) -> None:
    """One adam per group of top-level keys (``optax.multi_transform``
    and DDPG's two optimizers): gradients of ``loss`` w.r.t. the groups'
    leaves, each group stepped by its own adam and state."""
    subs = [{k: params[k] for k in keys} for _opt, _state, keys in groups]
    leaves = [tree_leaves(s) for s in subs]
    grads = grads_of(loss, [x for ls in leaves for x in ls])
    start = 0
    for (opt, state, _keys), sub, ls in zip(groups, subs, leaves):
        opt.update(sub, grads[start:start + len(ls)], state)
        start += len(ls)


class DDPGPolicy(Policy):
    """Deterministic actor + Q critic with target networks and Gaussian
    exploration noise."""

    twin_q = False
    policy_delay = 1
    smooth_target_policy = False

    def __init__(self, observation_dim: int, action_dim: int,
                 config: Optional[dict] = None):
        cfg, gen = _setup(self, dict(
            actor_lr=1e-3, critic_lr=1e-3, gamma=0.99, tau=0.005,
            noise_scale=0.1, target_noise=0.2, noise_clip=0.5,
            actor_l2=1e-2, hidden=(64, 64), seed=0, action_low=-1.0,
            action_high=1.0), config)
        self.action_dim = action_dim
        low = float(np.min(np.asarray(cfg["action_low"])))
        high = float(np.max(np.asarray(cfg["action_high"])))
        self._scale = (high - low) / 2.0
        self._mid = (high + low) / 2.0
        hidden = tuple(cfg["hidden"])
        critic = (observation_dim + action_dim, *hidden, 1)
        self.params = {
            "actor": init_mlp(gen, (observation_dim, *hidden, action_dim),
                              self.device),
            "q1": init_mlp(gen, critic, self.device),
        }
        if self.twin_q:
            self.params["q2"] = init_mlp(gen, critic, self.device)
        self.target = tree_clone(self.params)
        self.actor_opt = Adam(cfg["actor_lr"])
        self.critic_opt = Adam(cfg["critic_lr"])
        self._critic_keys = [k for k in self.params if k.startswith("q")]
        self.actor_state = self.actor_opt.init(self.params["actor"])
        self.critic_state = self.critic_opt.init(
            {k: self.params[k] for k in self._critic_keys})
        self._updates = 0

    def _act(self, params, obs):
        return torch.tanh(mlp_apply(params["actor"], obs)) * self._scale \
            + self._mid

    def _critic_loss(self, params, obs, actions, rewards, dones, next_obs,
                     noise):
        scale, mid, target = self._scale, self._mid, self.target
        with torch.no_grad():
            next_a = self._act(target, next_obs)
            if self.smooth_target_policy:  # TD3 target policy smoothing
                next_a = torch.clamp(next_a + noise, mid - scale,
                                     mid + scale)
            q_next = _q(target, "q1", next_obs, next_a)
            if self.twin_q:
                q_next = torch.minimum(q_next,
                                       _q(target, "q2", next_obs, next_a))
            y = rewards + self.cfg["gamma"] * (1.0 - dones) * q_next
        loss = torch.mean((_q(params, "q1", obs, actions) - y) ** 2)
        if self.twin_q:
            loss = loss + torch.mean((_q(params, "q2", obs, actions) - y)
                                     ** 2)
        return loss

    def _actor_loss(self, params, obs):
        raw = mlp_apply(params["actor"], obs)
        # pre-tanh L2 keeps the actor out of tanh saturation while the
        # critic is still settling (the reference's l2_reg serves the
        # same purpose, ddpg_tf_policy.py)
        act = torch.tanh(raw) * self._scale + self._mid
        return (-torch.mean(_q(params, "q1", obs, act))
                + self.cfg["actor_l2"] * torch.mean(raw ** 2))

    @torch.no_grad()
    def _forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self._act(self.params, obs)

    def compute_actions(self, obs) -> Tuple[np.ndarray, dict]:
        act = self._forward(self._obs(obs)).cpu().numpy()
        act = act + self._rng.normal(
            scale=self.cfg["noise_scale"] * self._scale, size=act.shape)
        low = self._mid - self._scale
        high = self._mid + self._scale
        return np.clip(act, low, high).astype(np.float32), {}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        obs = self._f32(batch[sb.OBS])
        acts = np.asarray(batch[sb.ACTIONS], np.float32)
        if acts.ndim == 1:
            acts = acts[:, None]
        noise = np.clip(
            self._rng.normal(scale=self.cfg["target_noise"],
                             size=(len(acts), self.action_dim)),
            -self.cfg["noise_clip"], self.cfg["noise_clip"])
        q_loss = self._critic_loss(
            self.params, obs, self._f32(acts), self._f32(batch[sb.REWARDS]),
            self._f32(batch[sb.DONES]), self._f32(batch[sb.NEXT_OBS]),
            self._f32(noise))
        _grouped_step([(self.critic_opt, self.critic_state,
                        self._critic_keys)], self.params, q_loss)
        stats = {"critic_loss": float(q_loss.detach())}
        self._updates += 1
        if self._updates % self.policy_delay == 0:  # TD3 delayed actor
            a_loss = self._actor_loss(self.params, obs)
            _grouped_step([(self.actor_opt, self.actor_state, ["actor"])],
                          self.params, a_loss)
            polyak_(self.target, self.params, self.cfg["tau"])
            stats["actor_loss"] = float(a_loss.detach())
        return stats

    def get_weights(self):
        return tree_to_numpy({"params": self.params,
                              "target": self.target})

    def set_weights(self, weights) -> None:
        self.params = tree_to_device(weights["params"], self.device)
        self.target = tree_to_device(weights["target"], self.device,
                                     trainable=False)


class TD3Policy(DDPGPolicy):
    """TD3 = DDPG + twin critics + delayed policy updates + target
    policy smoothing (reference: agents/ddpg/td3.py TD3_DEFAULT_CONFIG)."""

    twin_q = True
    policy_delay = 2
    smooth_target_policy = True


class ContinuousSACPolicy(Policy):
    """Soft actor-critic for continuous actions: squashed-Gaussian
    actor (reparameterized), twin soft-Q critics, learned temperature
    against a -action_dim entropy target (reference: agents/sac/
    sac_tf_policy.py — the continuous configuration; the discrete
    variant lives in policy_extra.SACPolicy).

    Subclasses extend the combined loss through ``_penalty`` (CQL adds
    its conservative penalty there) so the squashed-Gaussian math lives
    in exactly one place."""

    LOG_STD_MIN = -10.0
    LOG_STD_MAX = 2.0
    _report_penalty = False  # CQL reports its conservative penalty

    def __init__(self, observation_dim: int, action_dim: int,
                 config: Optional[dict] = None):
        cfg, gen = _setup(self, dict(
            actor_lr=3e-4, critic_lr=3e-4, alpha_lr=3e-4, gamma=0.99,
            tau=0.005, hidden=(64, 64), seed=0, init_alpha=0.1,
            action_low=-1.0, action_high=1.0), config)
        self.action_dim = action_dim
        low = float(np.min(np.asarray(cfg["action_low"])))
        high = float(np.max(np.asarray(cfg["action_high"])))
        self._scale = (high - low) / 2.0
        self._mid = (high + low) / 2.0
        hidden = tuple(cfg["hidden"])
        critic = (observation_dim + action_dim, *hidden, 1)
        self.params = {
            # actor emits mean and log_std
            "actor": init_mlp(gen, (observation_dim, *hidden,
                                    2 * action_dim), self.device),
            "q1": init_mlp(gen, critic, self.device),
            "q2": init_mlp(gen, critic, self.device),
            "log_alpha": torch.log(torch.tensor(
                cfg["init_alpha"], dtype=torch.float32,
                device=self.device)).requires_grad_(True),
        }
        self.target = tree_clone(self.params)
        # one combined loss, PER-COMPONENT learning rates
        # (optax.multi_transform: one adam per group)
        self._groups = []
        for lr, keys in (("actor_lr", ["actor"]), ("critic_lr", ["q1", "q2"]),
                         ("alpha_lr", ["log_alpha"])):
            opt = Adam(cfg[lr])
            self._groups.append(
                (opt, opt.init({k: self.params[k] for k in keys}), keys))
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(cfg["seed"]) + 1)
        self._target_entropy = -float(action_dim)

    def _actor_dist(self, params, obs):
        out = mlp_apply(params["actor"], obs)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, self.LOG_STD_MIN,
                                 self.LOG_STD_MAX)

    def _sample_action(self, params, obs, eps):
        mean, log_std = self._actor_dist(params, obs)
        std = torch.exp(log_std)
        pre_tanh = mean + std * eps
        a = torch.tanh(pre_tanh)
        # change-of-variables log-prob: tanh squash AND the affine
        # rescale to the action range (each contributes a Jacobian)
        logp = (-0.5 * (eps ** 2 + 2 * log_std
                        + np.float32(math.log(2 * math.pi)))
                - torch.log(torch.clamp(1 - a ** 2, min=1e-6))
                - np.float32(math.log(self._scale)))
        return a * self._scale + self._mid, torch.sum(logp, dim=-1)

    def _penalty(self, p, obs, actions, noise) -> torch.Tensor:
        """Scalar added to the combined loss (the CQL hook); 0 here."""
        return torch.zeros((), device=obs.device)

    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """One update's noise from the policy's generator: ``next`` and
        ``pi``, [B, action_dim] standard normals (the JAX package's
        ``k1`` and ``k2``)."""
        shape = (batch_size, self.action_dim)
        return {k: torch.randn(shape, generator=self._gen,
                               device=self.device) for k in ("next", "pi")}

    def _loss(self, params, obs, actions, rewards, dones, next_obs, noise):
        gamma = self.cfg["gamma"]
        with torch.no_grad():
            alpha = torch.exp(params["log_alpha"])
            next_a, next_logp = self._sample_action(params, next_obs,
                                                    noise["next"])
            q_next = torch.minimum(_q(self.target, "q1", next_obs, next_a),
                                   _q(self.target, "q2", next_obs, next_a))
            y = rewards + gamma * (1.0 - dones) * (q_next
                                                   - alpha * next_logp)
        p = params
        q1 = _q(p, "q1", obs, actions)
        q2 = _q(p, "q2", obs, actions)
        critic_loss = torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)
        penalty = self._penalty(p, obs, actions, noise)
        a, logp = self._sample_action(p, obs, noise["pi"])
        frozen = _detached(p)
        q_pi = torch.minimum(_q(frozen, "q1", obs, a),
                             _q(frozen, "q2", obs, a))
        alpha_live = torch.exp(p["log_alpha"])
        actor_loss = torch.mean(alpha_live.detach() * logp - q_pi)
        alpha_loss = -torch.mean(
            p["log_alpha"] * (logp + self._target_entropy).detach())
        total = critic_loss + penalty + actor_loss + alpha_loss
        return total, (critic_loss, actor_loss, alpha_live, penalty)

    @torch.no_grad()
    def _sample(self, obs: torch.Tensor) -> torch.Tensor:
        mean, _ = self._actor_dist(self.params, obs)
        eps = torch.randn(mean.shape, generator=self._gen,
                          device=self.device)
        return self._sample_action(self.params, obs, eps)[0]

    def compute_actions(self, obs) -> Tuple[np.ndarray, dict]:
        return self._sample(self._obs(obs)).cpu().numpy(), {}

    @torch.no_grad()
    def greedy_actions(self, obs) -> np.ndarray:
        mean, _ = self._actor_dist(self.params, self._obs(obs))
        return (torch.tanh(mean) * self._scale + self._mid).cpu().numpy()

    def learn_on_batch(self, batch: SampleBatch,
                       noise: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, float]:
        """One update. ``noise``: the tensors ``draw_noise`` would draw
        (a parity test passes the JAX key schedule's)."""
        acts = np.asarray(batch[sb.ACTIONS], np.float32)
        if acts.ndim == 1:
            acts = acts[:, None]
        if noise is None:
            noise = self.draw_noise(len(acts))
        total, aux = self._loss(
            self.params, self._f32(batch[sb.OBS]), self._f32(acts),
            self._f32(batch[sb.REWARDS]), self._f32(batch[sb.DONES]),
            self._f32(batch[sb.NEXT_OBS]),
            {k: v.to(self.device) for k, v in noise.items()})
        _grouped_step(self._groups, self.params, total)
        polyak_(self.target, self.params, self.cfg["tau"])
        aux = scalars(aux)
        stats = {"critic_loss": aux[0], "actor_loss": aux[1],
                 "alpha": aux[2]}
        if self._report_penalty:  # keyed on policy TYPE, not value —
            #                       a zero-weight CQL ablation still
            #                       reports its (zero) penalty
            stats["cql_penalty"] = aux[3]
        return stats

    def get_weights(self):
        return tree_to_numpy({"params": self.params,
                              "target": self.target})

    def set_weights(self, weights) -> None:
        self.params = tree_to_device(weights["params"], self.device)
        self.target = tree_to_device(weights["target"], self.device,
                                     trainable=False)


class CQLPolicy(ContinuousSACPolicy):
    """Conservative Q-learning for OFFLINE continuous control
    (reference: agents/cql/cql.py over the SAC policy): the combined
    loss adds min_q_weight * (logsumexp_a Q(s,a) - Q(s, a_data)),
    pushing Q down on out-of-distribution actions so the actor cannot
    exploit overestimated unseen actions in a static dataset. Everything
    else — the squashed-Gaussian math, targets, temperature — is the
    parent's, reused through the penalty hook."""

    _report_penalty = True

    def __init__(self, observation_dim: int, action_dim: int,
                 config: Optional[dict] = None):
        cfg = dict(min_q_weight=1.0, num_cql_actions=8)
        cfg.update(config or {})
        super().__init__(observation_dim, action_dim, cfg)

    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The parent's, and ``rand``: [B, num_cql_actions, action_dim]
        actions uniform over the action range (the JAX package's
        ``k3``)."""
        noise = super().draw_noise(batch_size)
        shape = (batch_size, self.cfg["num_cql_actions"], self.action_dim)
        noise["rand"] = torch.rand(
            shape, generator=self._gen, device=self.device) * \
            (2 * self._scale) + (self._mid - self._scale)
        return noise

    def _penalty(self, p, obs, actions, noise) -> torch.Tensor:
        rand_actions = noise["rand"]  # [B, N, A]
        b, n, _ = rand_actions.shape
        obs_rep = torch.repeat_interleave(obs, n, dim=0)
        flat_actions = rand_actions.reshape(b * n, -1)
        penalty = torch.zeros((), device=obs.device)
        for name in ("q1", "q2"):
            ood = _q(p, name, obs_rep, flat_actions).reshape(b, n)
            q_data = _q(p, name, obs, actions)
            penalty = penalty + torch.mean(
                torch.logsumexp(ood, dim=1) - q_data)
        return self.cfg["min_q_weight"] * penalty
