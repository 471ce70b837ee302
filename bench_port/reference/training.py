"""The reference's first optimizer steps: AdamW behind a clip of the
global gradient norm, in float32 (``optax.chain(clip_by_global_norm,
adamw)``'s semantics, weight decay on every leaf), on a family's float32
loss from the seed's weights and batches."""

from __future__ import annotations

from typing import List

import torch

from bench_port import inputs as inputs_pkg
from bench_port.reference import MATMUL, float32_exact


class AdamW:
    def __init__(self, params: List[torch.Tensor], hp: dict):
        self.hp = hp
        self.t = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> List[float]:
        """One step in place; returns each clipped gradient's norm."""
        hp = self.hp
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.where(norm < hp["grad_clip"], torch.ones_like(norm),
                            hp["grad_clip"] / norm)
        self.t += 1
        bc1 = 1 - hp["b1"] ** self.t
        bc2 = 1 - hp["b2"] ** self.t
        clipped = []
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g = g * scale
            clipped.append(g.norm().item())
            m.mul_(hp["b1"]).add_(g, alpha=1 - hp["b1"])
            v.mul_(hp["b2"]).addcmul_(g, g, value=1 - hp["b2"])
            step = (m / bc1) / (torch.sqrt(v / bc2) + hp.get("eps", 1e-8)) \
                + hp["weight_decay"] * p
            p.sub_(hp["learning_rate"] * step)
        return clipped


def _rows(batch, rows):
    if isinstance(batch, tuple):
        return tuple(t[rows] for t in batch)
    return batch[rows]


def _float_copy(tree):
    if isinstance(tree, dict):
        return {k: _float_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float_copy(v) for v in tree]
    return tree.detach().float().requires_grad_(True)


def train_readings(loss_fn, conf: dict, traffic: dict, seed: int,
                   steps: int, device, precision: str = "fp32",
                   batch_rows=None) -> dict:
    """``loss_fn(weights, batch, conf, mm)``'s first ``steps`` optimizer
    steps from the seed's weights on the seed's batches: each step's
    loss, each leaf's clipped first gradient norm and each leaf's change
    after the last step, by leaf name. ``batch_rows`` keeps only those
    rows of every batch (a planted fault)."""
    inputs = inputs_pkg.family(conf)
    mm = MATMUL[precision]
    with float32_exact():
        start = inputs.make_weights(conf, seed, device)
        names = [n for n, _ in inputs_pkg.flatten(start)]
        weights = _float_copy(start)
        leaves = [leaf for _, leaf in inputs_pkg.flatten(weights)]
        opt = AdamW(leaves, traffic["optimizer"])
        losses, grad1 = [], None
        for i in range(steps):
            batch = inputs.make_batch(conf, traffic, seed, i, device)
            if batch_rows is not None:
                batch = _rows(batch, batch_rows)
            value = loss_fn(weights, batch, conf, mm)
            grads = torch.autograd.grad(value, leaves)
            losses.append(value.item())
            norms = opt.update(leaves, list(grads))
            del grads
            if i == 0:
                grad1 = dict(zip(names, norms))
        change = {name: (new - old.float()).norm().item()
                  for name, new, old in zip(names, leaves,
                                            (t for _, t in
                                             inputs_pkg.flatten(start)))}
    return {"loss": losses, "grad1": grad1, "change": change}
