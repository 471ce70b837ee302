"""Flagship model family: decoder-only transformer, dense inference path.

Port of ``ray_tpu/models/transformer.py`` to plain functions on torch
tensors. Parameters keep the JAX package's pytree layout — a dict with
the layers stacked along a leading axis — so the two packages' weights
map one to one (``models/convert.py``); the layer loop is a Python loop
where the JAX package scans.

Architecture: RMSNorm, rotary embeddings, GQA attention via
``ops.flash_attention`` (the hand-written Hopper kernel on CUDA), SwiGLU
MLP. Not ported yet (a later slice): MoE layers, ``loss_fn``, remat.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.layers import (
    apply_rope,
    rms_norm,
    rope_frequencies,
    swiglu,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden: int = 512
    layers: int = 4
    heads: int = 8
    kv_heads: int = 8
    intermediate: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def debug(cls, **kw) -> "ModelConfig":
        return cls(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2,
                   intermediate=128, max_seq=128, dtype=torch.float32, **kw)

    @classmethod
    def b1(cls) -> "ModelConfig":
        """~1.2B dense (llama-ish shape)."""
        return cls(vocab_size=32000, hidden=2048, layers=24, heads=16,
                   kv_heads=16, intermediate=5632, max_seq=4096)

    @classmethod
    def b7(cls) -> "ModelConfig":
        return cls(vocab_size=32000, hidden=4096, layers=32, heads=32,
                   kv_heads=32, intermediate=11008, max_seq=4096)


# -- parameter init ----------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Random weights with the JAX package's shapes, scales and dtypes,
    drawn from ``generator`` on ``device`` (CUDA unless the caller asks
    for the CPU; a missing generator is seeded with 0). The numbers
    differ from the JAX package's (another RNG): parity tests convert
    the JAX weights instead (models/convert.py)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    h, hd, nl = cfg.hidden, cfg.head_dim, cfg.layers
    scale = h ** -0.5
    dt = cfg.dtype

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dt)

    def norm_init(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    params: Dict[str, Any] = {
        "embed": normal((cfg.vocab_size, h), 0.02),
        "final_norm": norm_init((h,)),
        "layers": {
            "attn_norm": norm_init((nl, h)),
            "mlp_norm": norm_init((nl, h)),
            "wq": normal((nl, h, cfg.heads * hd), scale),
            "wk": normal((nl, h, cfg.kv_heads * hd), scale),
            "wv": normal((nl, h, cfg.kv_heads * hd), scale),
            "wo": normal((nl, cfg.heads * hd, h), scale),
            "w_gate": normal((nl, h, cfg.intermediate), scale),
            "w_up": normal((nl, h, cfg.intermediate), scale),
            "w_down": normal((nl, cfg.intermediate, h),
                             cfg.intermediate ** -0.5),
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((h, cfg.vocab_size), scale)
    return params


# -- transformer block -------------------------------------------------------


def _flash_out(q, k, v):
    return flash_attention(q, k, v, True)[0]


def attention_block(x, layer, cfg: ModelConfig, cos, sin,
                    attention_fn: Callable) -> torch.Tensor:
    b, s, h = x.shape
    hd = cfg.head_dim
    xn = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = (xn @ layer["wq"]).reshape(b, s, cfg.heads, hd)
    k = (xn @ layer["wk"]).reshape(b, s, cfg.kv_heads, hd)
    v = (xn @ layer["wv"]).reshape(b, s, cfg.kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.kv_heads != cfg.heads:
        rep = cfg.heads // cfg.kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    attn = attention_fn(q, k, v)
    attn = attn.reshape(b, s, cfg.heads * hd)
    return x + attn @ layer["wo"]


def mlp_block(x, layer, cfg: ModelConfig) -> torch.Tensor:
    xn = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    return x + swiglu(xn, layer["w_gate"], layer["w_up"], layer["w_down"])


def hidden_states(params: Dict[str, Any], tokens: torch.Tensor,
                  cfg: ModelConfig,
                  attention_fn: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (final hidden states [B, S, H], aux). ``aux``
    is the MoE auxiliary loss, always 0 on this dense path."""
    if attention_fn is None:
        attention_fn = _flash_out
    embed = params["embed"]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=embed.device)
    x = embed[tokens]
    stacked = params["layers"]
    for i in range(cfg.layers):
        layer = {name: w[i] for name, w in stacked.items()}
        x = attention_block(x, layer, cfg, cos, sin, attention_fn)
        x = mlp_block(x, layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _unembed(params, cfg: ModelConfig):
    return (params["embed"].T if cfg.tie_embeddings
            else params["unembed"])


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            attention_fn: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (logits [B, S, V] float32, aux_loss)."""
    x, aux = hidden_states(params, tokens, cfg, attention_fn)
    logits = x.float() @ _unembed(params, cfg).float()
    return logits, aux
