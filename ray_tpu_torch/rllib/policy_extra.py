"""Additional PyTorch policies: A2C, discrete SAC, IMPALA and APPO
(V-trace).

Port of ray_tpu/rllib/policy_extra.py (reference behavior:
rllib/agents/a3c/ (synchronous variant = A2C), rllib/agents/sac/
(maximum-entropy, discrete-action head), and
rllib/agents/impala/vtrace.py (importance-corrected off-policy values)).
The parameter trees, device rule and optimizer are policy.py's;
``vtrace``'s ``lax.scan`` is a reverse loop over time on tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.policy import (
    Adam,
    Policy,
    _logsumexp,
    _setup,
    adam_step,
    entropy_of,
    grads_of,
    init_mlp,
    mlp_apply,
    polyak_,
    sample_categorical,
    scalars,
    take,
    tree_clone,
    tree_leaves,
    tree_map,
    tree_to_device,
    tree_to_numpy,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _actor_critic(policy: Policy, gen: torch.Generator,
                  observation_dim: int, num_actions: int) -> None:
    """The {"pi", "vf"} MLPs and one adam over both (A2C, IMPALA)."""
    hidden = tuple(policy.cfg["hidden"])
    policy.params = {
        "pi": init_mlp(gen, (observation_dim, *hidden, num_actions),
                       policy.device),
        "vf": init_mlp(gen, (observation_dim, *hidden, 1), policy.device),
    }
    policy.opt = Adam(policy.cfg["lr"])
    policy.opt_state = policy.opt.init(policy.params)


# ---------------------------------------------------------------------- A2C
class A2CPolicy(Policy):
    """Synchronous advantage actor-critic: one SGD pass per rollout
    batch over n-step returns (reference: a3c_torch_policy.py, run
    synchronously as A2C)."""

    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        _cfg, gen = _setup(self, dict(lr=1e-3, gamma=0.99,
                                      entropy_coeff=0.01, vf_coeff=0.5,
                                      hidden=(64, 64), seed=0), config)
        _actor_critic(self, gen, observation_dim, num_actions)

    @torch.no_grad()
    def _forward(self, obs: torch.Tensor):
        return (mlp_apply(self.params["pi"], obs),
                mlp_apply(self.params["vf"], obs)[..., 0])

    def _loss(self, p, obs, actions, returns):
        """The ONE loss definition; the synchronous update and the A3C
        seam (workers compute, learner applies) both compose from it."""
        cfg = self.cfg
        logits = mlp_apply(p["pi"], obs)
        values = mlp_apply(p["vf"], obs)[..., 0]
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = take(logp_all, actions)
        adv = (returns - values).detach()
        pg_loss = -torch.mean(logp * adv)
        vf_loss = torch.mean((values - returns) ** 2)
        entropy = entropy_of(logp_all)
        total = (pg_loss + cfg["vf_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * entropy)
        return total, (pg_loss, vf_loss, entropy)

    def _batch_loss(self, batch):
        return self._loss(self.params, self._f32(batch[sb.OBS]),
                          self._i64(batch[sb.ACTIONS]),
                          self._f32(batch[sb.RETURNS]))

    def compute_gradients(self, batch):
        """(grads, stats) from one postprocessed batch — the A3C seam.
        The gradients are host numpy in the parameters' tree, as
        ``jax.device_get`` gives them, so they ride the object store."""
        total, aux = self._batch_loss(batch)
        leaves = tree_leaves(self.params)
        grads = dict(zip(map(id, leaves),
                         grads_of(total, leaves)))
        pg, vf, ent = scalars(aux)
        return tree_to_numpy(tree_map(lambda p: grads[id(p)],
                                      self.params)), {
            "policy_loss": pg, "vf_loss": vf, "entropy": ent}

    def apply_gradients(self, grads) -> None:
        self.opt.update(self.params, tree_leaves(
            tree_to_device(grads, self.device, trainable=False)),
            self.opt_state)

    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, dict]:
        logits, values = self._forward(self._obs(obs))
        actions = sample_categorical(logits.cpu().numpy(), self._rng)
        return actions, {sb.VALUES: values.cpu().numpy()}

    def postprocess_trajectory(self, batch: SampleBatch) -> SampleBatch:
        rewards = np.asarray(batch[sb.REWARDS], np.float32)
        dones = np.asarray(batch[sb.DONES], bool)
        gamma = self.cfg["gamma"]
        n = len(rewards)
        returns = np.zeros(n, np.float32)
        # truncated (non-terminal) fragment: bootstrap from the value of
        # the state AFTER the last step, not the last observed state
        running = 0.0
        if not dones[-1]:
            _, v = self._forward(self._obs(batch[sb.NEXT_OBS][-1]))
            running = float(v.cpu().numpy()[0])
        for t in range(n - 1, -1, -1):
            if dones[t]:
                running = rewards[t]
            else:
                running = rewards[t] + gamma * running
            returns[t] = running
        batch[sb.RETURNS] = returns
        return batch

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        total, aux = self._batch_loss(batch)
        adam_step(self.opt, self.opt_state, self.params, total)
        pg, vf, ent = scalars(aux)
        return {"policy_loss": pg, "vf_loss": vf, "entropy": ent}

    def get_weights(self):
        return tree_to_numpy(self.params)

    def set_weights(self, weights) -> None:
        self.params = tree_to_device(weights, self.device)


# ---------------------------------------------------------------------- SAC
class SACPolicy(Policy):
    """Discrete-action soft actor-critic: twin soft-Q networks, a
    stochastic policy trained against the soft value, and temperature
    alpha tuned toward a target entropy (reference: agents/sac/ with the
    discrete-head variant)."""

    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        cfg, gen = _setup(self, dict(
            lr=3e-4, gamma=0.99, tau=0.01, seed=0, hidden=(64, 64),
            initial_alpha=0.2, target_entropy=None), config)
        if cfg["target_entropy"] is None:
            cfg["target_entropy"] = 0.4 * float(np.log(num_actions))
        self.num_actions = num_actions
        hidden = tuple(cfg["hidden"])
        sizes = (observation_dim, *hidden, num_actions)
        self.params = {
            "pi": init_mlp(gen, sizes, self.device),
            "q1": init_mlp(gen, sizes, self.device),
            "q2": init_mlp(gen, sizes, self.device),
            "log_alpha": torch.tensor(
                np.log(cfg["initial_alpha"]), dtype=torch.float32,
                device=self.device, requires_grad=True),
        }
        self.target = tree_clone({"q1": self.params["q1"],
                                  "q2": self.params["q2"]})
        self.opt = Adam(cfg["lr"])
        self.opt_state = self.opt.init(self.params)

    @torch.no_grad()
    def _logits(self, obs: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params["pi"], obs)

    def _loss(self, p, obs, actions, rewards, next_obs, dones):
        cfg, target = self.cfg, self.target
        alpha = torch.exp(p["log_alpha"])
        # soft state value of next state under the current policy
        next_logp = torch.log_softmax(mlp_apply(p["pi"], next_obs), dim=-1)
        next_probs = torch.exp(next_logp)
        q_t = torch.minimum(mlp_apply(target["q1"], next_obs),
                            mlp_apply(target["q2"], next_obs))
        v_next = torch.sum(next_probs * (q_t - alpha * next_logp), dim=1)
        target_q = rewards + cfg["gamma"] * (1.0 - dones) * v_next.detach()
        q1 = take(mlp_apply(p["q1"], obs), actions)
        q2 = take(mlp_apply(p["q2"], obs), actions)
        q_loss = torch.mean((q1 - target_q) ** 2 + (q2 - target_q) ** 2)
        # policy: maximize soft value under current Qs
        logp = torch.log_softmax(mlp_apply(p["pi"], obs), dim=-1)
        probs = torch.exp(logp)
        q_min = torch.minimum(mlp_apply(p["q1"], obs),
                              mlp_apply(p["q2"], obs)).detach()
        # detached alpha: the actor objective must not inject a
        # -alpha*H gradient into the temperature (that is the
        # alpha_loss controller's job alone)
        pi_loss = torch.mean(torch.sum(
            probs * (alpha.detach() * logp - q_min), dim=1))
        # temperature: match target entropy
        entropy = -torch.sum(probs * logp, dim=1)
        alpha_loss = torch.mean(
            p["log_alpha"] * (entropy - cfg["target_entropy"]).detach())
        return q_loss + pi_loss + alpha_loss, (
            q_loss, pi_loss, torch.mean(entropy), alpha)

    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, dict]:
        logits = self._logits(self._obs(obs)).cpu().numpy()
        return sample_categorical(logits, self._rng), {}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        total, aux = self._loss(
            self.params, self._f32(batch[sb.OBS]),
            self._i64(batch[sb.ACTIONS]), self._f32(batch[sb.REWARDS]),
            self._f32(batch[sb.NEXT_OBS]), self._f32(batch[sb.DONES]))
        adam_step(self.opt, self.opt_state, self.params, total)
        polyak_(self.target, {"q1": self.params["q1"],
                              "q2": self.params["q2"]}, self.cfg["tau"])
        q_loss, pi_loss, entropy, alpha = scalars(aux)
        return {"q_loss": q_loss, "policy_loss": pi_loss,
                "entropy": entropy, "alpha": alpha}

    def get_weights(self):
        return tree_to_numpy({"params": self.params,
                              "target": self.target})

    def set_weights(self, weights) -> None:
        self.params = tree_to_device(weights["params"], self.device)
        self.target = tree_to_device(weights["target"], self.device,
                                     trainable=False)


# ------------------------------------------------------------------- IMPALA
def vtrace(behavior_logp, target_logp, rewards, values, bootstrap,
           dones, gamma, clip_rho=1.0, clip_c=1.0):
    """V-trace targets (reference: rllib/agents/impala/vtrace.py, the
    IMPALA paper's off-policy correction): the JAX package's
    ``lax.scan`` over reversed time is a loop from the last step back.
    Tensors [T] (``bootstrap`` 0-dim) -> (vs [T], pg_advantages [T])."""
    rhos = torch.clamp(torch.exp(target_logp - behavior_logp), max=clip_rho)
    cs = torch.clamp(torch.exp(target_logp - behavior_logp), max=clip_c)
    discounts = gamma * (1.0 - dones)
    next_values = torch.cat([values[1:], bootstrap[None]])
    deltas = rhos * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(bootstrap)
    corrections = [acc] * len(deltas)
    for t in range(len(deltas) - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        corrections[t] = acc
    vs = values + torch.stack(corrections)
    next_vs = torch.cat([vs[1:], bootstrap[None]])
    pg_advantages = rhos * (rewards + discounts * next_vs - values)
    return vs, pg_advantages


class IMPALAPolicy(Policy):
    """Importance-weighted actor-learner: workers sample with a stale
    policy; the learner corrects via V-trace (reference:
    agents/impala/)."""

    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        _cfg, gen = _setup(self, dict(
            lr=6e-4, gamma=0.99, entropy_coeff=0.01, vf_coeff=0.5,
            clip_rho=1.0, clip_c=1.0, hidden=(64, 64), seed=0), config)
        _actor_critic(self, gen, observation_dim, num_actions)

    @torch.no_grad()
    def _forward(self, obs: torch.Tensor):
        return (mlp_apply(self.params["pi"], obs),
                mlp_apply(self.params["vf"], obs)[..., 0])

    def _loss(self, p, obs, actions, behavior_logp, rewards, dones,
              last_next_obs):
        cfg = self.cfg
        logits = mlp_apply(p["pi"], obs)
        values = mlp_apply(p["vf"], obs)[..., 0]
        logp_all = torch.log_softmax(logits, dim=-1)
        target_logp = take(logp_all, actions)
        # truncated fragments bootstrap from V(s_{T+1})
        bootstrap = torch.where(
            dones[-1] > 0, torch.zeros((), device=dones.device),
            mlp_apply(p["vf"], last_next_obs[None])[-1, 0])
        vs, pg_adv = vtrace(
            behavior_logp, target_logp.detach(), rewards, values.detach(),
            bootstrap.detach(), dones, cfg["gamma"], cfg["clip_rho"],
            cfg["clip_c"])
        pg_loss = self._pg_loss(target_logp, behavior_logp,
                                pg_adv.detach())
        vf_loss = torch.mean((values - vs.detach()) ** 2)
        entropy = entropy_of(logp_all)
        total = (pg_loss + cfg["vf_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * entropy)
        return total, (pg_loss, vf_loss, entropy)

    def _pg_loss(self, target_logp, behavior_logp, adv):
        """Policy-gradient term over V-trace advantages. The seam
        APPO overrides with the PPO clipped surrogate (the same
        loss-hook pattern as ContinuousSACPolicy/CQLPolicy)."""
        return -torch.mean(target_logp * adv)

    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, dict]:
        logits, _values = self._forward(self._obs(obs))
        logits = logits.cpu().numpy()
        actions = sample_categorical(logits, self._rng)
        logp_all = logits - _logsumexp(logits)
        logp = logp_all[np.arange(len(actions)), actions]
        return actions, {sb.LOGP: logp}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        total, aux = self._loss(
            self.params, self._f32(batch[sb.OBS]),
            self._i64(batch[sb.ACTIONS]), self._f32(batch[sb.LOGP]),
            self._f32(batch[sb.REWARDS]), self._f32(batch[sb.DONES]),
            self._f32(batch[sb.NEXT_OBS][-1]))
        adam_step(self.opt, self.opt_state, self.params, total)
        pg, vf, ent = scalars(aux)
        return {"policy_loss": pg, "vf_loss": vf, "entropy": ent}

    def get_weights(self):
        return tree_to_numpy(self.params)

    def set_weights(self, weights) -> None:
        self.params = tree_to_device(weights, self.device)


class APPOPolicy(IMPALAPolicy):
    """Asynchronous PPO (reference: rllib/agents/ppo/appo.py): IMPALA's
    actor-learner architecture and V-trace off-policy correction, with
    PPO's clipped surrogate as the policy loss — the ratio is taken
    against the BEHAVIOR policy that sampled the fragment, so stale
    workers neither explode the update nor need synchronous weight
    locks. Only the pg-loss hook differs from IMPALA."""

    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        cfg = dict(config or {})
        cfg.setdefault("clip_param", 0.2)
        self._clip_param = cfg["clip_param"]
        super().__init__(observation_dim, num_actions, cfg)

    def _pg_loss(self, target_logp, behavior_logp, adv):
        ratio = torch.exp(target_logp - behavior_logp)
        clipped = torch.clamp(ratio, 1.0 - self._clip_param,
                              1.0 + self._clip_param)
        return -torch.mean(torch.minimum(ratio * adv, clipped * adv))
