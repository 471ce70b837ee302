"""A decoder-only transformer of the Mistral family in plain float32,
from its published description (Hugging Face ``MistralForCausalLM``):
RMSNorm, rotary embeddings on the two halves of each head, grouped-query
attention (query head i reads key/value head i // (heads / kv heads)),
causal softmax attention, a SwiGLU MLP, no biases, an untied output head
and next-token cross entropy. No sliding window: the configurations set
none. Weights are the program's layout (``bench_port.inputs.decoder``).

Memory: attention runs a block of query rows at a time, training keeps
each layer's input and recomputes the layer in the backward, and the
loss takes one batch row at a time, so the 4 x 4096 step fits beside
its float32 weights, gradients and moments.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_port.reference import MATMUL, float32_exact
from bench_port.reference import training

QUERY_BLOCK = 512
LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate",
              "w_up", "w_down")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(conf: dict, length: int, device):
    hd = conf["head_dim"]
    inv = 1.0 / (conf["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    angles = torch.outer(torch.arange(length, dtype=torch.float32,
                                      device=device), inv)
    return torch.cos(angles), torch.sin(angles)


def rope(x, cos, sin):
    """x [B, S, H, D]: the rotation of (x[:D/2], x[D/2:]) pairs."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attend(q, k, v, start: int, mm):
    """Rows start.. of causal attention; q [B, H, c, D], k/v [B, H, n, D]
    with n = start + c."""
    scores = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    rows = torch.arange(start, start + q.shape[2], device=q.device)
    keys = torch.arange(k.shape[2], device=q.device)
    scores = scores.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v)


def attention(q, k, v, mm):
    """Causal attention of [B, S, H, D] tensors (k/v with all H heads),
    QUERY_BLOCK query rows at a time."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    out = []
    for a in range(0, q.shape[2], QUERY_BLOCK):
        e = min(q.shape[2], a + QUERY_BLOCK)
        args = (q[:, :, a:e], k[:, :, :e], v[:, :, :e], a, mm)
        out.append(checkpoint(_attend, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _attend(*args))
    return torch.cat(out, dim=2).transpose(1, 2)


def block(x, lw: dict, conf: dict, cos, sin, mm):
    b, s, _ = x.shape
    heads, kv, hd = (conf["num_attention_heads"],
                     conf["num_key_value_heads"], conf["head_dim"])
    eps = conf["rms_norm_eps"]
    h = rms_norm(x, lw["attn_norm"], eps)
    q = rope(mm(h, lw["wq"]).view(b, s, heads, hd), cos, sin)
    k = rope(mm(h, lw["wk"]).view(b, s, kv, hd), cos, sin)
    v = mm(h, lw["wv"]).view(b, s, kv, hd)
    k = k.repeat_interleave(heads // kv, dim=2)
    v = v.repeat_interleave(heads // kv, dim=2)
    x = x + mm(attention(q, k, v, mm).reshape(b, s, heads * hd), lw["wo"])
    h = rms_norm(x, lw["mlp_norm"], eps)
    return x + mm(F.silu(mm(h, lw["w_gate"])) * mm(h, lw["w_up"]),
                  lw["w_down"])


def _unembed(weights: dict, conf: dict):
    return weights["embed"].T if conf["tie_word_embeddings"] \
        else weights["unembed"]


def _row_nll(x_row, t_row, final_norm, unembed, eps, mm):
    logits = mm(rms_norm(x_row, final_norm, eps), unembed)
    return F.cross_entropy(logits, t_row, reduction="sum")


def loss(weights: dict, tokens: torch.Tensor, conf: dict, mm) -> torch.Tensor:
    """Mean next-token cross entropy of tokens [B, S + 1]; every layer
    recomputed in the backward."""
    inp, targets = tokens[:, :-1], tokens[:, 1:]
    cos, sin = rope_tables(conf, inp.shape[1], tokens.device)
    x = weights["embed"][inp]
    layers = zip(*(weights["layers"][k].unbind(0) for k in LAYER_KEYS))
    for parts in layers:
        x = checkpoint(block, x, dict(zip(LAYER_KEYS, parts)), conf, cos,
                       sin, mm, use_reentrant=False)
    unembed = _unembed(weights, conf)
    total = sum(checkpoint(_row_nll, x[r], targets[r], weights["final_norm"],
                           unembed, conf["rms_norm_eps"], mm,
                           use_reentrant=False)
                for r in range(x.shape[0]))
    return total / targets.numel()


def train_readings(conf: dict, traffic: dict, seed: int, steps: int, device,
                   precision: str = "fp32", batch_rows=None) -> dict:
    """``reference.training.train_readings`` of this family's loss."""
    return training.train_readings(loss, conf, traffic, seed, steps, device,
                                   precision, batch_rows)


@torch.no_grad()
def score_last(conf: dict, weights: dict, prompts: List[torch.Tensor],
               precision: str = "fp32") -> torch.Tensor:
    """[len(prompts), vocab] float32: the logits at each prompt's last
    position, one layer at a time over all prompts (each layer's weights
    in float32 only while it runs)."""
    mm = MATMUL[precision]
    with float32_exact():
        device = weights["embed"].device
        longest = max(p.numel() for p in prompts)
        cos, sin = rope_tables(conf, longest, device)
        xs = [weights["embed"][p.to(device)][None].float() for p in prompts]
        for i in range(conf["num_hidden_layers"]):
            lw = {k: weights["layers"][k][i].float() for k in LAYER_KEYS}
            xs = [block(x, lw, conf, cos[:x.shape[1]], sin[:x.shape[1]], mm)
                  for x in xs]
            del lw
        final = weights["final_norm"].float()
        unembed = _unembed(weights, conf).float()
        return torch.cat([mm(rms_norm(x[:, -1], final, conf["rms_norm_eps"]),
                             unembed) for x in xs])
