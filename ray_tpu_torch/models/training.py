"""Train step, optimizer and inference entry for the model family.

Port of ``ray_tpu/models/training.py`` on one device, without a mesh:

  make_optimizer     AdamW behind a global-norm clip, with optax's
                     semantics (``optax.chain(clip_by_global_norm,
                     adamw)``);
  build_train_step   (step, init_fn): ``step(params, opt_state, tokens)``
                     takes one optimizer step on the next-token loss and
                     returns (params, opt_state, {"loss", "grad_norm"});
  build_forward      the inference forward.

Sharded training (the mesh rules, sequence parallelism, FSDP) and the
pipeline step wait for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import transformer as tfm

ADAM_EPS = 1e-8  # optax.adamw's default, which make_optimizer keeps


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts and lists of tensors, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...))`` as a
    plain function on tensors, updating parameters and moments in place.

    Per update: the global norm n = sqrt(sum of every grad squared);
    grads are scaled by grad_clip / n when n >= grad_clip (optax's
    trigger); mu/nu are AdamW's moments with bias correction 1 - b**t;
    the update is lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)
    on every leaf (no mask). Moments are kept in each parameter's dtype,
    as optax keeps them. The arithmetic runs in fp32 and rounds the
    moments and parameters once per update; optax rounds wherever XLA
    lowers a bf16 op, so bf16 parameters can differ by one bf16 step
    (fp32 parameters agree up to summation order)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, params, grads: List[torch.Tensor],
               state: Dict[str, Any]) -> torch.Tensor:
        """One step in place on ``params`` and ``state``; ``grads`` in
        ``tree_leaves(params)`` order. Returns the pre-clip global norm
        (a 0-dim float32 tensor on the parameters' device)."""
        leaves = tree_leaves(params)
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = norm < self.grad_clip
        state["count"] += 1
        t = torch.tensor(state["count"], dtype=torch.float32)
        bc1 = (1 - torch.tensor(self.b1) ** t).item()
        bc2 = (1 - torch.tensor(self.b2) ** t).item()
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            g = g.float()
            g = torch.where(keep, g, g / norm * self.grad_clip)
            m = (1 - self.b1) * g + self.b1 * mu.float()
            v = (1 - self.b2) * g.square() + self.b2 * nu.float()
            mu.copy_(m)
            nu.copy_(v)
            step = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS) \
                + self.weight_decay * p.float()
            p.copy_(p.float() - self.learning_rate * step)
        return norm


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0) -> ClippedAdamW:
    return ClippedAdamW(learning_rate=learning_rate,
                        weight_decay=weight_decay, b1=b1, b2=b2,
                        grad_clip=grad_clip)


def build_train_step(cfg: tfm.ModelConfig, device=None,
                     optimizer: Optional[ClippedAdamW] = None
                     ) -> Tuple[Callable, Callable]:
    """Single-device train step on ``device`` (CUDA unless the caller
    asks for the CPU) -> (step, init_fn).

    ``init_fn(generator=None)`` -> (params, opt_state), weights drawn by
    ``tfm.init_params``. ``step(params, opt_state, tokens [B, S+1])`` ->
    (params, opt_state, {"loss", "grad_norm"}), both 0-dim float32
    tensors: the loss before the update and the global grad norm before
    the clip. Parameters and optimizer state are updated IN PLACE (the
    returned objects are the ones passed in), which keeps one copy of the
    weights on the card where the JAX step donates its buffers."""
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()

    def init_fn(generator: Optional[torch.Generator] = None):
        params = tfm.init_params(cfg, generator, device=device)
        return params, optimizer.init(params)

    def step(params, opt_state, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = tfm.loss_fn(params, tokens, cfg)
        # a weight no layer uses gets zeros, as lax.cond gives in the JAX
        # step (e.g. the dense MLP when every layer is a MoE layer)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        grad_norm = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(),
                                   "grad_norm": grad_norm}

    return step, init_fn


def build_forward(cfg: tfm.ModelConfig, device=None,
                  attention_fn: Optional[Callable] = None) -> Callable:
    """Inference forward ``fwd(params, tokens) -> logits [B, S, V] f32``
    on ``device`` (CUDA unless the caller asks for the CPU). Tokens are
    moved to the device; no autograd graph is kept. ``attention_fn``
    (default: the flash-attention kernel path) swaps the attention."""
    device = resolve_device(device)

    @torch.no_grad()
    def fwd(params, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        logits, _ = tfm.forward(params, tokens, cfg, attention_fn)
        return logits

    return fwd
