"""Flagship model family: decoder-only transformer (dense + MoE).

Port of ``ray_tpu/models/transformer.py`` to plain functions on torch
tensors. Parameters keep the JAX package's pytree layout — a dict with
the layers stacked along a leading axis — so the two packages' weights
map one to one (``models/convert.py``); the layer loop is a Python loop
where the JAX package scans.

Architecture: RMSNorm, rotary embeddings, GQA attention via
``ops.flash_attention`` (the hand-written Hopper kernels on CUDA, forward
and backward), SwiGLU MLP, optional top-k MoE layers (GShard-style
capacity-bounded einsum dispatch, optionally in checkpointed token
groups); ``loss_fn`` with optional chunked cross entropy and the MoE
auxiliary loss, and remat of each layer through
``torch.utils.checkpoint``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
    # MoE: every `moe_every`-th layer is sparse when num_experts > 0
    num_experts: int = 0
    experts_per_token: int = 2
    moe_every: int = 2
    capacity_factor: float = 1.25
    # grouped dispatch: when >0 and it divides B*S, tokens route in
    # independent groups of this size with per-group capacity, each under
    # checkpoint, so the [tokens, experts, capacity] dispatch and combine
    # tensors scale with the group, not the batch (per-group capacity is
    # GShard's local-group semantics)
    moe_group_size: int = 0
    remat: bool = True
    # remat granularity when ``remat`` is on: "full" recomputes the whole
    # layer in the backward (lowest memory); "dots" saves the weight
    # matmul outputs and recomputes the rest, the counterpart of
    # jax.checkpoint_policies.dots_with_no_batch_dims_saveable (attention
    # products have batch dims and are never saved)
    remat_policy: str = "full"
    tie_embeddings: bool = True
    # chunked cross-entropy: when >0 and it divides the sequence, the
    # loss projects to vocab one [B, chunk, V] slab at a time under
    # checkpoint, so the fp32 [B, S, V] logits never materialize
    logits_chunk: int = 0

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', "
                f"got {self.remat_policy!r}")
        if self.moe_group_size < 0:
            raise ValueError(
                f"moe_group_size must be >= 0, "
                f"got {self.moe_group_size}")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def debug(cls, **kw) -> "ModelConfig":
        return cls(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2,
                   intermediate=128, max_seq=128, dtype=torch.float32, **kw)

    @classmethod
    def tiny_moe(cls, **kw) -> "ModelConfig":
        return cls(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=4,
                   intermediate=128, max_seq=128, num_experts=4,
                   dtype=torch.float32, **kw)

    @classmethod
    def b1(cls) -> "ModelConfig":
        """~1.2B dense (llama-ish shape)."""
        return cls(vocab_size=32000, hidden=2048, layers=24, heads=16,
                   kv_heads=16, intermediate=5632, max_seq=4096)

    @classmethod
    def moe_bench(cls) -> "ModelConfig":
        """bench.py's sparse row (``bench_model``'s ``moe_cfg``): top-2 of
        8 experts on every second layer, 4096-token groups."""
        return cls(vocab_size=32000, hidden=1024, layers=8, heads=16,
                   kv_heads=8, intermediate=2816, max_seq=2048,
                   logits_chunk=256, num_experts=8, experts_per_token=2,
                   moe_every=2, moe_group_size=4096)

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
    if cfg.num_experts > 0:
        e, inter = cfg.num_experts, cfg.intermediate
        # drawn for every layer, as the JAX package does, though only
        # every moe_every-th layer uses them
        params["layers"]["moe"] = {
            "router": (torch.randn((nl, h, e), generator=generator,
                                   device=device) * scale),
            "w_gate": normal((nl, e, h, inter), scale),
            "w_up": normal((nl, e, h, inter), scale),
            "w_down": normal((nl, e, inter, h), inter ** -0.5),
        }
    return params


# -- MoE ---------------------------------------------------------------------


def moe_layer(x: torch.Tensor, moe_params: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-bounded MoE (GShard-style einsum dispatch).

    x: [B, S, H] -> ([B, S, H], aux_loss scalar). With
    ``cfg.moe_group_size`` set and dividing B*S, tokens route in
    independent groups, each under ``torch.utils.checkpoint`` when
    autograd is on (without it the backward would keep every group's
    [g, E, C] dispatch residuals live at once); the aux loss is averaged
    over groups."""
    b, s, h = x.shape
    t = b * s
    g = cfg.moe_group_size
    xt = x.reshape(t, h)
    if g and t > g:
        if t % g == 0:
            grad = torch.is_grad_enabled()
            aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            outs = []
            for xg in xt.split(g):
                if grad:
                    out, aux = checkpoint(_moe_tokens, xg, moe_params, cfg,
                                          use_reentrant=False)
                else:
                    out, aux = _moe_tokens(xg, moe_params, cfg)
                outs.append(out)
                aux_sum = aux_sum + aux
            return torch.cat(outs).reshape(b, s, h), aux_sum / (t // g)
        # dropping the grouping silently would reintroduce the ungrouped
        # [T, E, capacity] dispatch tensors this option exists to prevent
        logging.getLogger(__name__).warning(
            "moe_group_size=%d does not divide token count %d; "
            "falling back to UNGROUPED routing (dispatch tensors "
            "scale with the full batch — may OOM at large batch)",
            g, t)
    out, aux = _moe_tokens(xt, moe_params, cfg)
    return out.reshape(b, s, h), aux


def _moe_tokens(xt: torch.Tensor, moe_params: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route one token set [T, H] -> ([T, H], aux). The router, the
    dispatch and the combine run in fp32, the experts in ``xt``'s
    dtype."""
    t, h = xt.shape
    e = cfg.num_experts
    k = cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    xf = xt.float()
    logits = xf @ moe_params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)      # [T, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch Transformer eq. 4)
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=xt.device).index_add(
        0, gate_idx.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), device=xt.device))
    aux = e * torch.sum(me * ce)
    # position of each (token, choice) within its expert's capacity:
    # choice 0 of token t counts before its choice 1
    onehot = F.one_hot(gate_idx, e).float()                 # [T, k, E]
    flat = onehot.reshape(t * k, e)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
    within = (pos * onehot).sum(-1)                         # [T, k]
    keep = within < cap
    gate_vals = gate_vals * keep
    pos_onehot = F.one_hot(
        torch.clamp(within, 0, cap - 1).long(), cap).float()  # [T, k, C]
    # dispatch and combine [T, E, C]. The JAX package writes the combine
    # as einsum("tke,tkc,tk->tec"); folding the gate into the one-hot
    # first is the same product bit for bit (one nonzero term per
    # (t, e, c): a token's k choices are distinct experts) without the
    # [T, k, E, C] intermediate a three-operand einsum makes here
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep[..., None],
                            pos_onehot)
    combine = torch.einsum("tke,tkc->tec", onehot * gate_vals[..., None],
                           pos_onehot)
    expert_in = torch.einsum("tec,th->ech", dispatch, xf).to(xt.dtype)
    # SwiGLU per expert: batched over E by the stacked expert weights
    expert_out = swiglu(expert_in, moe_params["w_gate"],
                        moe_params["w_up"], moe_params["w_down"])  # [E, C, H]
    out = torch.einsum("tec,ech->th", combine,
                       expert_out.float()).to(xt.dtype)
    return out, aux


# -- transformer block -------------------------------------------------------


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


def mlp_block(x, layer, layer_idx: int, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x + MLP(x), aux). Layer ``layer_idx`` is a MoE layer when the
    config has experts and it is the last of each ``moe_every``; only the
    branch taken runs (``lax.cond`` in the JAX package)."""
    xn = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.num_experts > 0 and "moe" in layer and \
            layer_idx % cfg.moe_every == cfg.moe_every - 1:
        out, aux = moe_layer(xn, layer["moe"], cfg)
    else:
        out = swiglu(xn, layer["w_gate"], layer["w_up"], layer["w_down"])
    return x + out, aux


def _block(x, layer, layer_idx: int, cfg: ModelConfig, cos, sin,
           attention_fn):
    x = attention_block(x, layer, cfg, cos, sin, attention_fn)
    return mlp_block(x, layer, layer_idx, cfg)


# "dots": matmuls without batch dims (x @ W reaches aten.mm), as JAX's
# dots_with_no_batch_dims_saveable
_DOT_OPS = [torch.ops.aten.mm.default]


def _remat_kwargs(cfg: ModelConfig) -> Dict[str, Any]:
    kw: Dict[str, Any] = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOT_OPS)
    return kw


def hidden_states(params: Dict[str, Any], tokens: torch.Tensor,
                  cfg: ModelConfig,
                  attention_fn: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (final hidden states [B, S, H], aux). ``aux``
    is the MoE auxiliary loss summed over the layers (0 without MoE
    layers). With ``cfg.remat`` and autograd on, each layer runs under
    ``torch.utils.checkpoint`` and its forward is recomputed in the
    backward."""
    if attention_fn is None:
        attention_fn = functools.partial(flash_attention, causal=True)
    embed = params["embed"]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=embed.device)
    x = embed[tokens]
    remat = cfg.remat and torch.is_grad_enabled()
    kw = _remat_kwargs(cfg) if remat else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for idx, layer in enumerate(_per_layer(params["layers"], cfg.layers)):
        if remat:
            x, layer_aux = checkpoint(_block, x, layer, idx, cfg, cos, sin,
                                      attention_fn, **kw)
        else:
            x, layer_aux = _block(x, layer, idx, cfg, cos, sin,
                                  attention_fn)
        aux = aux + layer_aux
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _per_layer(stacked: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The stacked layer dict (nested dicts kept, as ``layers.moe``) as n
    per-layer dicts. unbind, not w[i]: its backward stacks the layers'
    grads once instead of adding a full-stack zero tensor per layer, and
    fills zeros for a layer that leaves a weight unused."""
    layers: List[Dict[str, Any]] = [{} for _ in range(n)]
    for name, value in stacked.items():
        parts = (_per_layer(value, n) if isinstance(value, dict)
                 else value.unbind(0))
        for layer, part in zip(layers, parts):
            layer[name] = part
    return layers


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


def _chunk_nll(x_c, t_c, unembed):
    logits = x_c.float() @ unembed.float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, t_c[..., None])[..., 0].sum()


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross entropy over tokens[:, :-1] -> tokens[:, 1:],
    plus 0.01 x the MoE aux loss.

    When ``cfg.logits_chunk`` divides the sequence, the vocab projection
    and log-softmax run one sequence chunk at a time under checkpoint, so
    the fp32 [B, S, V] logits never materialize; the backward recomputes
    one [B, C, V] chunk at a time."""
    x, aux = hidden_states(params, tokens[:, :-1], cfg, attention_fn)
    targets = tokens[:, 1:]
    unembed = _unembed(params, cfg)
    b, s, _ = x.shape
    chunk = cfg.logits_chunk
    if chunk and (s % chunk != 0 and s > chunk):
        # a non-dividing chunk would silently reintroduce the full
        # [B,S,V] fp32 logits — the allocation this option exists to avoid
        logging.getLogger(__name__).warning(
            "logits_chunk=%d does not divide sequence length %d; "
            "falling back to UNCHUNKED loss (full [B,S,V] fp32 logits "
            "materialize — may OOM at large batch x vocab)", chunk, s)
    if chunk and s % chunk == 0 and s > chunk:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, s, chunk):
            total = total + checkpoint(
                _chunk_nll, x[:, c:c + chunk], targets[:, c:c + chunk],
                unembed, use_reentrant=False)
        return total / (b * s) + 0.01 * aux
    logits = x.float() @ unembed.float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return nll.mean() + 0.01 * aux
