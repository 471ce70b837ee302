"""PyTorch policies: PPO (clipped surrogate + GAE) and DQN (double-Q TD).

Port of ray_tpu/rllib/policy.py (reference: rllib/policy/ +
rllib/agents/{ppo,dqn}/ behavior). A policy is a set of functions over
a parameter tree in the JAX package's layout: dicts and lists of float32
tensors, each layer ``{"w": [fan_in, fan_out], "b": [fan_out]}``
applied as ``x @ w + b`` with tanh between layers. So ``get_weights()``
returns exactly the JAX package's pytree of numpy arrays, and
``set_weights`` takes a tree from either package (:func:`tree_to_device`).

Device rule: every policy takes a ``device`` key in its config; ``None``
(the default) means CUDA through ``_private/device.py::resolve_device``,
which raises without CUDA. Parameters, optimizer state and every tensor
of an update live there; the numpy side (sampling by Gumbel-max, GAE,
shuffles, epsilon decay) is the JAX package's, draw for draw.

optax's ``adam`` is :class:`Adam`, the same step in optax's order of
operations. ``jax.lax.stop_gradient`` is ``.detach()`` at the same
places.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.sample_batch import SampleBatch


# ------------------------------------------------------- parameter trees
def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in JAX's flattening order (dict keys sorted), so the order
    the optimizer state follows does not depend on which package built
    a tree's dicts (``jax.device_get`` rebuilds them sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_to_device(tree, device, trainable: bool = True):
    """A tree of arrays from either package (numpy, or anything
    ``np.asarray`` takes) -> float32 tensors on ``device``, copied, so an
    update never writes into the caller's arrays. The function that
    carries the JAX package's parameters across, as ``models/convert.py``
    is for the transformer."""
    def leaf(x):
        t = torch.tensor(np.asarray(x, np.float32), device=device)
        return t.requires_grad_(trainable)

    return tree_map(leaf, tree)


def tree_to_numpy(tree):
    """Host numpy float32, as ``jax.device_get`` gives; non-tensor
    leaves (DQN's epsilon) pass through."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def tree_clone(tree):
    """A snapshot of a tree (a target network): JAX's arrays are
    immutable, so its ``tree_map(lambda x: x, params)`` is one."""
    return tree_map(lambda t: t.detach().clone(), tree)


@torch.no_grad()
def polyak_(target, online, tau: float) -> None:
    """``target <- (1 - tau) * target + tau * online`` in place, leaf by
    leaf, with the JAX package's arithmetic."""
    for t, o in zip(tree_leaves(target), tree_leaves(online)):
        t.copy_((1 - tau) * t + tau * o)


# ------------------------------------------------------------- optimizer
class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) as a
    step on tensors in place, in optax's order of operations:

        mu <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu;  t <- t + 1
        p  <- p + (-lr) (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with the bias corrections in float32, as optax computes them from
    its int32 count. State: the count and one mu and nu per leaf in
    ``tree_leaves`` order."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p, requires_grad=False)
                       for p in leaves],
                "nu": [torch.zeros_like(p, requires_grad=False)
                       for p in leaves]}

    @torch.no_grad()
    def update(self, params, grads: Sequence[torch.Tensor],
               state: Dict[str, Any]) -> None:
        state["count"] += 1
        t = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        for p, g, mu, nu in zip(tree_leaves(params), grads, state["mu"],
                                state["nu"]):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-self.lr * update)


def grads_of(loss: torch.Tensor, leaves) -> list:
    """d loss / d leaf for each leaf; zeros for a leaf the loss does not
    reach (VDN's unused mixer), as ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)]


def adam_step(opt: Adam, state: Dict[str, Any], params,
              loss: torch.Tensor) -> None:
    """Gradients of ``loss`` w.r.t. every leaf of ``params``, then one
    ``opt`` step on them."""
    opt.update(params, grads_of(loss, tree_leaves(params)), state)


# -------------------------------------------------------------- MLP core
def init_mlp(generator: torch.Generator, sizes: Sequence[int],
             device) -> list:
    """Layers ``{"w", "b"}``: w ~ N(0, 1) * sqrt(2 / fan_in) drawn on the
    CPU from ``generator`` (so a seed gives the same weights on every
    device), b = 0; float32 on ``device``, trainable."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator) * \
            np.float32(np.sqrt(2.0 / fan_in))
        params.append({
            "w": w.to(device).requires_grad_(True),
            "b": torch.zeros(fan_out, device=device, requires_grad=True)})
    return params


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(values, index[..., None], -1)[..., 0]``."""
    return torch.gather(values, -1, index[..., None])[..., 0]


def scalars(values) -> list:
    """Host floats of 0-dim loss terms, read in one transfer."""
    return torch.stack([v.detach() for v in values]).tolist()


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=1))


class Policy:
    device: torch.device

    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, dict]:
        raise NotImplementedError

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        raise NotImplementedError

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, weights) -> None:
        raise NotImplementedError

    def postprocess_trajectory(self, batch: SampleBatch) -> SampleBatch:
        return batch

    # -------------------------------------------------- host -> device
    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=self.device)

    def _i64(self, x) -> torch.Tensor:
        # gather takes int64 indices; the JAX package feeds int32
        return torch.as_tensor(np.asarray(x, np.int64),
                               device=self.device)

    def _obs(self, obs) -> torch.Tensor:
        return self._f32(np.atleast_2d(np.asarray(obs, np.float32)))


def _setup(policy: Policy, defaults: dict, config: Optional[dict]
           ) -> Tuple[dict, torch.Generator]:
    """The config (defaults, then the caller's, ``device`` None -> CUDA),
    the device, the numpy RNG and the init generator, all from
    ``cfg["seed"]``."""
    cfg = dict(defaults, device=None)
    cfg.update(config or {})
    policy.cfg = cfg
    policy.device = resolve_device(cfg["device"])
    policy._rng = np.random.default_rng(cfg["seed"])
    return cfg, torch.Generator().manual_seed(int(cfg["seed"]))


# ---------------------------------------------------------------------- PPO
class PPOPolicy(Policy):
    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        cfg, gen = _setup(self, dict(
            lr=3e-4, gamma=0.99, lam=0.95, clip_param=0.2,
            entropy_coeff=0.01, vf_coeff=0.5, num_sgd_iter=6,
            sgd_minibatch_size=128, hidden=(64, 64), seed=0), config)
        hidden = tuple(cfg["hidden"])
        self.params = {
            "pi": init_mlp(gen, (observation_dim, *hidden, num_actions),
                           self.device),
            "vf": init_mlp(gen, (observation_dim, *hidden, 1), self.device),
        }
        self.opt = Adam(cfg["lr"])
        self.opt_state = self.opt.init(self.params)

    @torch.no_grad()
    def _forward(self, obs: torch.Tensor):
        return (mlp_apply(self.params["pi"], obs),
                mlp_apply(self.params["vf"], obs)[..., 0])

    def _loss(self, p, obs, actions, old_logp, advantages, returns):
        cfg = self.cfg
        logits = mlp_apply(p["pi"], obs)
        values = mlp_apply(p["vf"], obs)[..., 0]
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = take(logp_all, actions)
        ratio = torch.exp(logp - old_logp)
        clipped = torch.clamp(ratio, 1 - cfg["clip_param"],
                              1 + cfg["clip_param"])
        pg_loss = -torch.mean(
            torch.minimum(ratio * advantages, clipped * advantages))
        vf_loss = torch.mean((values - returns) ** 2)
        entropy = entropy_of(logp_all)
        total = (pg_loss + cfg["vf_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * entropy)
        return total, (pg_loss, vf_loss, entropy)

    # ------------------------------------------------------------ acting
    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, dict]:
        logits, values = self._forward(self._obs(obs))
        logits = logits.cpu().numpy()
        actions = sample_categorical(logits, self._rng)
        logp_all = logits - _logsumexp(logits)
        logp = logp_all[np.arange(len(actions)), actions]
        return actions, {sb.VALUES: values.cpu().numpy(),
                         sb.LOGP: logp}

    # ------------------------------------------------- GAE postprocessing
    def postprocess_trajectory(self, batch: SampleBatch) -> SampleBatch:
        rewards = np.asarray(batch[sb.REWARDS], np.float32)
        values = np.asarray(batch[sb.VALUES], np.float32)
        dones = np.asarray(batch[sb.DONES], bool)
        gamma, lam = self.cfg["gamma"], self.cfg["lam"]
        n = len(rewards)
        adv = np.zeros(n, np.float32)
        last = 0.0
        for t in range(n - 1, -1, -1):
            next_v = 0.0 if (t == n - 1 or dones[t]) else values[t + 1]
            nonterminal = 0.0 if dones[t] else 1.0
            delta = rewards[t] + gamma * next_v - values[t]
            last = delta + gamma * lam * nonterminal * last
            adv[t] = last
        batch[sb.ADVANTAGES] = adv
        batch[sb.RETURNS] = adv + values
        return batch

    # ------------------------------------------------------------ learning
    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        adv = np.asarray(batch[sb.ADVANTAGES], np.float32)
        batch[sb.ADVANTAGES] = (adv - adv.mean()) / (adv.std() + 1e-8)
        aux = torch.zeros(3)
        for _ in range(self.cfg["num_sgd_iter"]):
            shuffled = batch.shuffle(self._rng)
            for mb in shuffled.minibatches(self.cfg["sgd_minibatch_size"]):
                total, aux = self._loss(
                    self.params, self._f32(mb[sb.OBS]),
                    self._i64(mb[sb.ACTIONS]), self._f32(mb[sb.LOGP]),
                    self._f32(mb[sb.ADVANTAGES]),
                    self._f32(mb[sb.RETURNS]))
                adam_step(self.opt, self.opt_state, self.params, total)
        stats = scalars(aux)
        return {"policy_loss": stats[0], "vf_loss": stats[1],
                "entropy": stats[2]}

    def get_weights(self):
        return tree_to_numpy(self.params)

    def set_weights(self, weights) -> None:
        self.params = tree_to_device(weights, self.device)


# ---------------------------------------------------------------------- DQN
class DQNPolicy(Policy):
    def __init__(self, observation_dim: int, num_actions: int,
                 config: Optional[dict] = None):
        cfg, gen = _setup(self, dict(
            lr=1e-3, gamma=0.99, epsilon=1.0, epsilon_min=0.05,
            epsilon_decay=0.995, target_update_freq=200, hidden=(64, 64),
            seed=0, double_q=True), config)
        self.num_actions = num_actions
        hidden = tuple(cfg["hidden"])
        self.params = init_mlp(gen, (observation_dim, *hidden, num_actions),
                               self.device)
        self.target_params = tree_clone(self.params)
        self.opt = Adam(cfg["lr"])
        self.opt_state = self.opt.init(self.params)
        self.epsilon = cfg["epsilon"]
        self._steps = 0

    @torch.no_grad()
    def _q(self, obs: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params, obs)

    def _loss(self, p, obs, actions, rewards, next_obs, dones):
        q_taken = take(mlp_apply(p, obs), actions)
        q_next_target = mlp_apply(self.target_params, next_obs)
        if self.cfg["double_q"]:
            best = torch.argmax(mlp_apply(p, next_obs), dim=1)
            q_next = take(q_next_target, best)
        else:
            q_next = torch.max(q_next_target, dim=1).values
        target = rewards + self.cfg["gamma"] * (1.0 - dones) * \
            q_next.detach()
        return torch.mean((q_taken - target) ** 2)

    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, dict]:
        q = self._q(self._obs(obs)).cpu().numpy()
        actions = np.argmax(q, axis=1)
        explore = self._rng.random(len(actions)) < self.epsilon
        random_actions = self._rng.integers(self.num_actions,
                                            size=len(actions))
        actions = np.where(explore, random_actions, actions)
        return actions, {}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        loss = self._loss(
            self.params, self._f32(batch[sb.OBS]),
            self._i64(batch[sb.ACTIONS]), self._f32(batch[sb.REWARDS]),
            self._f32(batch[sb.NEXT_OBS]), self._f32(batch[sb.DONES]))
        adam_step(self.opt, self.opt_state, self.params, loss)
        self._steps += 1
        if self._steps % self.cfg["target_update_freq"] == 0:
            self.target_params = tree_clone(self.params)
        self.epsilon = max(self.cfg["epsilon_min"],
                           self.epsilon * self.cfg["epsilon_decay"])
        return {"td_loss": float(loss.detach()), "epsilon": self.epsilon}

    def get_weights(self):
        return tree_to_numpy({"params": self.params,
                              "target": self.target_params,
                              "epsilon": self.epsilon})

    def set_weights(self, weights) -> None:
        self.params = tree_to_device(weights["params"], self.device)
        self.target_params = tree_to_device(weights["target"], self.device,
                                            trainable=False)
        self.epsilon = weights["epsilon"]


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=1, keepdims=True))


def sample_categorical(logits: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    """Gumbel-max sampling on host — keeps the forward stateless.
    Shared by every discrete policy."""
    u = rng.uniform(1e-9, 1.0, size=logits.shape)
    return np.argmax(logits - np.log(-np.log(u)), axis=1)

