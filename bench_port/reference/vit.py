"""ViT in plain float32 from its published description (Dosovitskiy et
al., arXiv:2010.11929): 16 x 16 patches flattened in (row, column,
channel) order and projected, a class token, learned position
embeddings, pre-norm blocks of multi-head self-attention (non-causal)
and a two-layer GELU MLP, a final LayerNorm and a linear head on the
class token, mean cross entropy.

Departures from the paper that the configuration file states as the
program's (``departures``): LayerNorm without a bias, no biases in the
attention and MLP projections (the patch embedding and the head keep
theirs), and GELU in its tanh form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_port.reference import training


def layer_norm(x, w, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w


def patches(images, p: int):
    b, h, w, c = images.shape
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def block(x, blk: dict, conf: dict, mm):
    b, s, d = x.shape
    heads = conf["num_heads"]
    h = layer_norm(x, blk["norm1"], conf["layer_norm_eps"])
    q, k, v = (t.reshape(b, s, heads, d // heads).transpose(1, 2)
               for t in mm(h, blk["wqkv"]).chunk(3, dim=-1))
    scores = mm(q, k.transpose(-1, -2)) * (d // heads) ** -0.5
    att = mm(torch.softmax(scores, dim=-1), v).transpose(1, 2)
    x = x + mm(att.reshape(b, s, d), blk["wo"])
    h = layer_norm(x, blk["norm2"], conf["layer_norm_eps"])
    return x + mm(F.gelu(mm(h, blk["w1"]), approximate="tanh"), blk["w2"])


def logits(weights: dict, images, conf: dict, mm):
    x = mm(patches(images, conf["patch_size"]), weights["patch_w"]) \
        + weights["patch_b"]
    cls = weights["cls"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + weights["pos"][None]
    for blk in weights["blocks"]:
        x = checkpoint(block, x, blk, conf, mm, use_reentrant=False) \
            if torch.is_grad_enabled() else block(x, blk, conf, mm)
    x = layer_norm(x, weights["norm_out"], conf["layer_norm_eps"])
    return mm(x[:, 0], weights["head_w"]) + weights["head_b"]


def loss(weights: dict, batch, conf: dict, mm):
    images, labels = batch
    return F.cross_entropy(logits(weights, images, conf, mm), labels)


def train_readings(conf: dict, traffic: dict, seed: int, steps: int, device,
                   precision: str = "fp32", batch_rows=None) -> dict:
    """``reference.training.train_readings`` of this family's loss."""
    return training.train_readings(loss, conf, traffic, seed, steps, device,
                                   precision, batch_rows)
