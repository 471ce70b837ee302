"""REINFORCE-family PyTorch policies: vanilla PG and MARWIL (offline).

Port of ray_tpu/rllib/policy_pg.py (reference behavior: rllib/agents/pg/,
policy-gradient with return-to-go, and rllib/agents/marwil/, monotonic
advantage re-weighted imitation learning; BC is MARWIL at beta=0). The
parameter trees, device rule and optimizer are policy.py's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.policy import (
    Adam,
    Policy,
    _setup,
    adam_step,
    init_mlp,
    mlp_apply,
    sample_categorical,
    scalars,
    take,
    tree_to_device,
    tree_to_numpy,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class PGPolicy(Policy):
    """Vanilla policy gradient: -logp * (G - V(s)) with a learned value
    baseline (reference: agents/pg/pg_tf_policy.py post_process_advantages
    uses discounted return-to-go)."""

    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        cfg, gen = _setup(self, dict(lr=5e-3, gamma=0.99, vf_coeff=0.5,
                                     hidden=(64, 64), seed=0), config)
        hidden = tuple(cfg["hidden"])
        self.params = {
            "pi": init_mlp(gen, (observation_dim, *hidden, num_actions),
                           self.device),
            "vf": init_mlp(gen, (observation_dim, *hidden, 1), self.device),
        }
        self.opt = Adam(cfg["lr"])
        self.opt_state = self.opt.init(self.params)

    @torch.no_grad()
    def _forward(self, obs: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params["pi"], obs)

    def _terms(self, p, obs, actions, returns):
        logits = mlp_apply(p["pi"], obs)
        values = mlp_apply(p["vf"], obs)[..., 0]
        logp = take(torch.log_softmax(logits, dim=-1), actions)
        return values, logp, returns - values.detach()

    def _loss(self, p, obs, actions, returns):
        values, logp, adv = self._terms(p, obs, actions, returns)
        pg_loss = -torch.mean(logp * adv)
        vf_loss = torch.mean((values - returns) ** 2)
        return pg_loss + self.cfg["vf_coeff"] * vf_loss, (pg_loss, vf_loss)

    def compute_actions(self, obs) -> Tuple[np.ndarray, dict]:
        logits = self._forward(self._obs(obs)).cpu().numpy()
        return sample_categorical(logits, self._rng), {}

    def postprocess_trajectory(self, batch: SampleBatch) -> SampleBatch:
        rewards = np.asarray(batch[sb.REWARDS], np.float32)
        dones = np.asarray(batch[sb.DONES], bool)
        gamma = self.cfg["gamma"]
        returns = np.zeros_like(rewards)
        acc = 0.0
        for t in range(len(rewards) - 1, -1, -1):
            acc = rewards[t] + gamma * (0.0 if dones[t] else acc)
            returns[t] = acc
        batch[sb.RETURNS] = returns
        return batch

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        total, aux = self._loss(
            self.params, self._f32(batch[sb.OBS]),
            self._i64(batch[sb.ACTIONS]), self._f32(batch[sb.RETURNS]))
        adam_step(self.opt, self.opt_state, self.params, total)
        pg_loss, vf_loss = scalars(aux)
        return {"policy_loss": pg_loss, "vf_loss": vf_loss}

    def get_weights(self):
        return tree_to_numpy(self.params)

    def set_weights(self, weights) -> None:
        self.params = tree_to_device(weights, self.device)


class MARWILPolicy(PGPolicy):
    """MARWIL: imitation weighted by exp(beta * normalized advantage);
    beta=0 degenerates to behavior cloning (reference:
    agents/marwil/marwil_tf_policy.py, including the moving advantage
    norm c^2 <- c^2 + lr_c (A^2 - c^2))."""

    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        cfg = dict(beta=1.0, vf_coeff=1.0, ma_lr=1e-3)
        cfg.update(config or {})
        super().__init__(observation_dim, num_actions, cfg)
        self._adv_norm = 1.0  # moving estimate of E[A^2]

    def _marwil_loss(self, p, obs, actions, returns, adv_norm):
        cfg = self.cfg
        values, logp, adv = self._terms(p, obs, actions, returns)
        weight = torch.exp(cfg["beta"] * adv / (adv_norm + 1e-8))
        bc_loss = -torch.mean(weight.detach() * logp)
        vf_loss = torch.mean((values - returns) ** 2)
        mean_adv_sq = torch.mean(adv ** 2)
        return (bc_loss + cfg["vf_coeff"] * vf_loss,
                (bc_loss, vf_loss, mean_adv_sq))

    def compute_actions(self, obs) -> Tuple[np.ndarray, dict]:
        # evaluation is greedy: imitation policies act by argmax
        logits = self._forward(self._obs(obs)).cpu().numpy()
        return np.argmax(logits, axis=1), {}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        total, aux = self._marwil_loss(
            self.params, self._f32(batch[sb.OBS]),
            self._i64(batch[sb.ACTIONS]), self._f32(batch[sb.RETURNS]),
            self._f32(np.sqrt(self._adv_norm)))
        adam_step(self.opt, self.opt_state, self.params, total)
        bc_loss, vf_loss, mean_adv_sq = scalars(aux)
        self._adv_norm += self.cfg["ma_lr"] * (mean_adv_sq
                                               - self._adv_norm)
        return {"bc_loss": bc_loss, "vf_loss": vf_loss,
                "adv_norm": float(self._adv_norm)}
