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
``torch.utils.checkpoint``. Given a ``parallel.mesh.RankLayout`` the
functions take a mesh rank's shards of the parameters (heads, mlp
columns and vocab rows over tp, experts over dp, the hidden axis over dp
under FSDP) and issue the collectives that GSPMD inserts in the JAX
package, so that they compute the unsharded model's function (MoE
groups that span ranks included).
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


def logical_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Same-structure tree of logical axis tuples, consumed by
    parallel.mesh.sharding_for."""
    axes: Dict[str, Any] = {
        "embed": ("vocab", "hidden"),
        "final_norm": ("hidden",),
        "layers": {
            "attn_norm": ("layers", "hidden"),
            "mlp_norm": ("layers", "hidden"),
            "wq": ("layers", "hidden", "heads"),
            "wk": ("layers", "hidden", "kv_heads"),
            "wv": ("layers", "hidden", "kv_heads"),
            "wo": ("layers", "heads", "hidden"),
            "w_gate": ("layers", "hidden", "mlp"),
            "w_up": ("layers", "hidden", "mlp"),
            "w_down": ("layers", "mlp", "hidden"),
        },
    }
    if not cfg.tie_embeddings:
        axes["unembed"] = ("hidden", "vocab")
    if cfg.num_experts > 0:
        axes["layers"]["moe"] = {
            "router": ("layers", "hidden", None),
            "w_gate": ("layers", "experts", "hidden", "mlp"),
            "w_up": ("layers", "experts", "hidden", "mlp"),
            "w_down": ("layers", "experts", "mlp", "hidden"),
        }
    return axes


# -- MoE ---------------------------------------------------------------------


def moe_layer(x: torch.Tensor, moe_params: Dict[str, torch.Tensor],
              cfg: ModelConfig, layout=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-bounded MoE (GShard-style einsum dispatch).

    x: [B, S, H] -> ([B, S, H], aux_loss scalar). With
    ``cfg.moe_group_size`` set and dividing B*S, tokens route in
    independent groups of that many consecutive tokens of the row-major
    [B, S] order, each under ``torch.utils.checkpoint`` when autograd is
    on (without it the backward would keep every group's [g, E, C]
    dispatch residuals live at once); the aux loss is averaged over
    groups.

    ``layout`` (a ``parallel.mesh.RankLayout``): x is this rank's
    [B/dp, S/sp] window of the global batch, the experts its [E/dp] shard
    (their mlp columns cut over tp), and the layer computes what it
    computes on the global batch: B*S, the grouping, the capacity, the
    slot positions and the aux loss are the global ones. A group that
    lies within one of the rank's runs of consecutive tokens (its rows,
    or under sp its row segments) routes there; otherwise the groups
    span ranks (``_moe_spread``). The aux loss returned is this rank's
    share of it (the shares sum to it over dp and sp)."""
    b, s, h = x.shape
    t = b * s
    dp, sp = (layout.dp, layout.sp) if layout is not None else (1, 1)
    total = t * dp * sp
    g = cfg.moe_group_size
    if g and total > g and total % g:
        # dropping the grouping silently would reintroduce the ungrouped
        # [T, E, capacity] dispatch tensors this option exists to prevent
        logging.getLogger(__name__).warning(
            "moe_group_size=%d does not divide token count %d; "
            "falling back to UNGROUPED routing (dispatch tensors "
            "scale with the full batch — may OOM at large batch)",
            g, total)
    group = g if g and total > g and total % g == 0 else total
    run = s if sp > 1 else t  # consecutive global tokens a rank holds
    if run % group:
        return _moe_spread(x, moe_params, cfg, layout, group)
    xt = x.reshape(t, h)
    grad = torch.is_grad_enabled() and group < total
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    for xg in xt.split(group):
        if grad:
            out, aux = checkpoint(_moe_tokens, xg, moe_params, cfg, layout,
                                  use_reentrant=False)
        else:
            out, aux = _moe_tokens(xg, moe_params, cfg, layout)
        outs.append(out)
        aux_sum = aux_sum + aux
    return torch.cat(outs).reshape(b, s, h), aux_sum / (total // group)


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """The router in fp32 -> (probs [T, E], top-k gates renormalised
    [T, k], their experts [T, k])."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)      # [T, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _dispatch(xt: torch.Tensor, onehot: torch.Tensor,
              gate_vals: torch.Tensor, within: torch.Tensor, cap: int):
    """(expert_in [E, C, H] in xt's dtype, combine [T, E, C] fp32) of
    tokens xt [T, H] whose (token, choice) pairs take slot ``within`` of
    their expert's ``cap``; a pair past the capacity is dropped."""
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
    expert_in = torch.einsum("tec,th->ech", dispatch,
                             xt.float()).to(xt.dtype)
    return expert_in, combine


def _combine(combine: torch.Tensor, expert_out: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    return torch.einsum("tec,ech->th", combine,
                        expert_out.float()).to(dtype)


def _moe_tokens(xt: torch.Tensor, moe_params: Dict[str, torch.Tensor],
                cfg: ModelConfig, layout=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route one token set [T, H] that lies on this rank -> ([T, H],
    aux). The router, the dispatch and the combine run in fp32, the
    experts in ``xt``'s dtype."""
    t, h = xt.shape
    e = cfg.num_experts
    k = cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    probs, gate_vals, gate_idx = _route(xt, moe_params["router"], k)
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
    expert_in, combine = _dispatch(xt, onehot, gate_vals, within, cap)
    if layout is None:
        # SwiGLU per expert: batched over E by the stacked expert weights
        expert_out = swiglu(expert_in, moe_params["w_gate"],
                            moe_params["w_up"],
                            moe_params["w_down"])           # [E, C, H]
    else:
        expert_out = _experts_on_mesh(expert_in, moe_params, layout)
    return _combine(combine, expert_out, xt.dtype), aux


def _experts_on_mesh(expert_in: torch.Tensor,
                     moe_params: Dict[str, torch.Tensor], layout
                     ) -> torch.Tensor:
    """The experts' SwiGLU on a rank's own [E, C, H] slots when each dp
    rank holds E/dp experts (their mlp columns cut over tp): the slots
    are swapped all-to-all over dp to their expert's rank and the
    outputs swapped back."""
    x = expert_in
    if layout.dp > 1:
        x = layout.alltoall(x, "dp", 0, 1)                # [E/dp, dp*C, H]
    y = layout.psum(swiglu(x, moe_params["w_gate"], moe_params["w_up"],
                           moe_params["w_down"]), "tp")
    if layout.dp > 1:
        return layout.alltoall(y, "dp", 1, 0)
    return y


def _moe_spread(x: torch.Tensor, moe_params: Dict[str, torch.Tensor],
                cfg: ModelConfig, layout, group: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_layer`` on a mesh when its groups of ``group`` consecutive
    tokens of the global row-major [B, S] order span ranks (every token
    in one group when the routing is ungrouped). A rank (d, s) holds rows
    d·B/dp… and columns s·S/sp… of that order, so a group's tokens may lie
    on ranks of both axes; the tokens stay where they are and the group
    is routed from counts:

      - the slot of a (token, choice) is the count of its expert among
        the group's earlier tokens: the per-expert counts of every
        earlier row segment (gathered over dp and sp, in the global
        order), plus the earlier tokens of its own segment, less the
        count at the group's first token (taken from the rank that holds
        it, summed over the ranks);
      - the capacity comes from the group size; the aux loss's means are
        each group's, summed over the ranks; the rank returns its
        1/(dp·sp) share of their average;
      - a group's slots are filled by at most one token across the
        ranks, so summing the ranks' [E, C, H] slots (over sp, then a
        reduce-scatter to the experts' dp rank) is exact, in any dtype;
        the expert outputs are gathered back over dp and each rank
        combines its own tokens.

    Every rank steps through every group in order (a rank holding none
    of a group's tokens adds zeros), so all build the same graph and
    issue the same collectives, each group under ``checkpoint`` when
    grouped and autograd is on; the backward of each collective is its
    transpose."""
    b, s, h = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    dp, sp = layout.dp, layout.sp
    total = t * dp * sp
    n_groups = total // group
    cap = max(1, int(cfg.capacity_factor * group * k / e))
    xt = x.reshape(t, h)
    dev = x.device
    probs, gate_vals, gate_idx = _route(xt, moe_params["router"], k)
    onehot = F.one_hot(gate_idx, e).float()                 # [T, k, E]
    rows = layout.dp_rank * b + torch.arange(b, device=dev)
    index = (rows[:, None] * (s * sp) + layout.sp_rank * s
             + torch.arange(s, device=dev)[None]).reshape(t)
    gid = index // group  # non-decreasing: a group's tokens are a run
    with torch.no_grad():
        within = _spread_slots(onehot, index, gid, b, s, n_groups, group,
                               layout)
        ce = layout.psum_data(torch.zeros(
            (n_groups, e), device=dev).index_add(0, gid, onehot.sum(1)))
    # load-balancing auxiliary loss (Switch Transformer eq. 4), per group
    me = layout.psum_data(torch.zeros(
        (n_groups, e), device=dev).index_add(0, gid, probs)) / group
    aux = e * (me * ce / (group * k)).sum(-1).mean()
    sizes = torch.bincount(gid, minlength=n_groups).tolist()
    grad = torch.is_grad_enabled() and group < total
    outs = []
    for part in zip(xt.split(sizes), onehot.split(sizes),
                    gate_vals.split(sizes), within.split(sizes)):
        if grad:
            outs.append(checkpoint(_spread_group, *part, cap, moe_params,
                                   layout, use_reentrant=False))
        else:
            outs.append(_spread_group(*part, cap, moe_params, layout))
    return torch.cat(outs).reshape(b, s, h), aux / (dp * sp)


def _spread_slots(onehot: torch.Tensor, index: torch.Tensor,
                  gid: torch.Tensor, b: int, s: int, n_groups: int,
                  group: int, layout) -> torch.Tensor:
    """The slot [T, k] of each local (token, choice) within its group
    (``_moe_spread``): counts are exact in fp32 below 2^24."""
    t, _, e = onehot.shape
    per_token = onehot.sum(1).reshape(b, s, e)
    every = layout.stack_data(per_token.sum(1))             # [dp, sp, b, E]
    segments = every.permute(0, 2, 1, 3).reshape(-1, e)     # global order
    before = (segments.cumsum(0) - segments).reshape(
        layout.dp, b, layout.sp, e)[layout.dp_rank, :, layout.sp_rank]
    count = (per_token.cumsum(1) - per_token
             + before[:, None]).reshape(t, e)  # each earlier token's
    first = index % group == 0
    starts = layout.psum_data(torch.zeros(
        (n_groups, e), device=onehot.device).index_add(
            0, gid[first], count[first]))
    return ((count - starts[gid])[:, None, :] * onehot).sum(-1)


def _spread_group(xg: torch.Tensor, onehot: torch.Tensor,
                  gate_vals: torch.Tensor, within: torch.Tensor, cap: int,
                  moe_params: Dict[str, torch.Tensor], layout
                  ) -> torch.Tensor:
    """One group of ``_moe_spread`` through the experts -> this rank's
    tokens' outputs [T_g, H] (T_g may be 0)."""
    expert_in, combine = _dispatch(xg, onehot, gate_vals, within, cap)
    slots = layout.psum(expert_in, "sp")
    if layout.dp > 1:
        slots = layout.reduce_scatter(slots, "dp")        # [E/dp, C, H]
    y = layout.psum(swiglu(slots, moe_params["w_gate"], moe_params["w_up"],
                           moe_params["w_down"]), "tp")
    if layout.dp > 1:
        y = layout.gather(y, "dp", 0)
    return _combine(combine, y, xg.dtype)


# -- transformer block -------------------------------------------------------


def attention_block(x, layer, cfg: ModelConfig, cos, sin,
                    attention_fn: Callable, layout=None) -> torch.Tensor:
    """x + attention(x). With ``layout`` (tp > 1) ``wq``/``wk``/``wv``
    are this rank's column shards, so its heads are heads / tp of them,
    and ``wo`` its row shard, whose output is summed over tp. When tp
    does not divide kv_heads a kv head's columns span ranks: ``wk`` and
    ``wv`` are gathered over tp and each local q head takes its kv head
    (``h // group``)."""
    b, s, h = x.shape
    hd = cfg.head_dim
    tp = layout.tp if layout is not None else 1
    heads = cfg.heads // tp
    xn = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = (xn @ layer["wq"]).reshape(b, s, heads, hd)
    if cfg.kv_heads % tp:
        wk, wv = (layout.gather(layer[n], "tp", -1) for n in ("wk", "wv"))
        kv_heads = cfg.kv_heads
    else:
        wk, wv, kv_heads = layer["wk"], layer["wv"], cfg.kv_heads // tp
    k = (xn @ wk).reshape(b, s, kv_heads, hd)
    v = (xn @ wv).reshape(b, s, kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.kv_heads % tp:
        group = cfg.heads // cfg.kv_heads
        idx = torch.arange(layout.tp_rank * heads,
                           (layout.tp_rank + 1) * heads,
                           device=x.device) // group
        k, v = k[:, :, idx], v[:, :, idx]
    elif kv_heads != heads:
        rep = heads // kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    attn = attention_fn(q, k, v)
    attn = attn.reshape(b, s, heads * hd)
    out = attn @ layer["wo"]
    return x + (out if layout is None else layout.psum(out, "tp"))


def mlp_block(x, layer, layer_idx: int, cfg: ModelConfig, layout=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x + MLP(x), aux). Layer ``layer_idx`` is a MoE layer when the
    config has experts and it is the last of each ``moe_every``; only the
    branch taken runs (``lax.cond`` in the JAX package). With ``layout``
    the dense MLP's ``w_gate``/``w_up`` are column shards and ``w_down``
    a row shard, its output summed over tp."""
    xn = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.num_experts > 0 and "moe" in layer and \
            layer_idx % cfg.moe_every == cfg.moe_every - 1:
        out, aux = moe_layer(xn, layer["moe"], cfg, layout)
    else:
        out = swiglu(xn, layer["w_gate"], layer["w_up"], layer["w_down"])
        if layout is not None:
            out = layout.psum(out, "tp")
    return x + out, aux


def _fsdp_gather(tree: Dict[str, Any], axes: Dict[str, Any], layout
                 ) -> Dict[str, Any]:
    """Under FSDP each leaf of ``tree`` gathered over dp along its
    "hidden" dimension (``axes``: the leaves' logical axes); else
    ``tree``. Called where the weights are used, inside a checkpointed
    layer, so that its recompute gathers again instead of keeping the
    full weights."""
    if layout is None or not layout.fsdp:
        return tree
    return {name: (_fsdp_gather(value, axes[name], layout)
                   if isinstance(value, dict)
                   else _fsdp_leaf(value, axes[name], layout))
            for name, value in tree.items()}


def _fsdp_leaf(value: torch.Tensor, axes: tuple, layout) -> torch.Tensor:
    if layout is None or not layout.fsdp or "hidden" not in axes:
        return value
    return layout.gather(value, "dp", axes.index("hidden"))


def _layer_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of one layer's leaves (``logical_axes``' layer
    stack without its leading "layers" axis)."""
    def strip(tree):
        return {k: strip(v) if isinstance(v, dict) else v[1:]
                for k, v in tree.items()}

    return strip(logical_axes(cfg)["layers"])


def _block(x, layer, layer_idx: int, cfg: ModelConfig, cos, sin,
           attention_fn, layout=None):
    layer = _fsdp_gather(layer, _layer_axes(cfg), layout)
    x = attention_block(x, layer, cfg, cos, sin, attention_fn, layout)
    return mlp_block(x, layer, layer_idx, cfg, layout)


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
                  attention_fn: Optional[Callable] = None,
                  position_offset: int = 0, layout=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (final hidden states [B, S, H], aux). ``aux``
    is the MoE auxiliary loss summed over the layers (0 without MoE
    layers). ``position_offset``: the position of tokens[:, 0] in the
    sequence (a sequence-parallel rank's shard starts past 0).
    ``layout``: a ``parallel.mesh.RankLayout`` when ``params`` are a
    mesh rank's shards (tp, FSDP, experts over dp); the hidden states
    are then replicated over tp."""
    embed = params["embed"]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=embed.device)
    x, aux = run_layers(embed_tokens(params, tokens, cfg, layout),
                        per_layer(params["layers"], cfg.layers),
                        cfg, cos[position_offset:], sin[position_offset:],
                        attention_fn, layout=layout)
    final_norm = _fsdp_leaf(params["final_norm"],
                            logical_axes(cfg)["final_norm"], layout)
    return rms_norm(x, final_norm, cfg.norm_eps), aux


def embed_tokens(params: Dict[str, Any], tokens: torch.Tensor,
                 cfg: ModelConfig, layout=None) -> torch.Tensor:
    """The embedding rows of ``tokens``. With ``layout`` (tp > 1) the
    table is this rank's [V/tp] rows: the lookup is masked to them and
    summed over tp (one nonzero term: exact)."""
    embed = _fsdp_leaf(params["embed"], logical_axes(cfg)["embed"], layout)
    if layout is None or layout.tp == 1:
        return embed[tokens]
    rows = embed.shape[0]
    local = tokens - layout.tp_rank * rows
    owned = (local >= 0) & (local < rows)
    x = embed[local.clamp(0, rows - 1)] * owned[..., None].to(embed.dtype)
    return layout.psum(x, "tp")


def run_layers(x: torch.Tensor, layers: List[Dict[str, Any]],
               cfg: ModelConfig, cos, sin,
               attention_fn: Optional[Callable] = None,
               first_layer: int = 0, layout=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H] through ``layers`` (per-layer dicts, ``per_layer``),
    the first of them the model's layer ``first_layer`` -> (x, aux
    summed over them). With ``cfg.remat`` and autograd on, each layer
    runs under ``torch.utils.checkpoint`` and its forward is recomputed
    in the backward."""
    if attention_fn is None:
        attention_fn = functools.partial(flash_attention, causal=True)
    remat = cfg.remat and torch.is_grad_enabled()
    kw = _remat_kwargs(cfg) if remat else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for idx, layer in enumerate(layers, start=first_layer):
        if remat:
            x, layer_aux = checkpoint(_block, x, layer, idx, cfg, cos, sin,
                                      attention_fn, layout, **kw)
        else:
            x, layer_aux = _block(x, layer, idx, cfg, cos, sin,
                                  attention_fn, layout)
        aux = aux + layer_aux
    return x, aux


def per_layer(stacked: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The stacked layer dict (nested dicts kept, as ``layers.moe``) as n
    per-layer dicts. unbind, not w[i]: its backward stacks the layers'
    grads once instead of adding a full-stack zero tensor per layer, and
    fills zeros for a layer that leaves a weight unused."""
    layers: List[Dict[str, Any]] = [{} for _ in range(n)]
    for name, value in stacked.items():
        parts = (per_layer(value, n) if isinstance(value, dict)
                 else value.unbind(0))
        for layer, part in zip(layers, parts):
            layer[name] = part
    return layers


def _unembed(params, cfg: ModelConfig, layout=None):
    """[H, V] (this rank's [H, V/tp] columns under tp)."""
    name = "embed" if cfg.tie_embeddings else "unembed"
    w = _fsdp_leaf(params[name], logical_axes(cfg)[name], layout)
    return w.T if cfg.tie_embeddings else w


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            attention_fn: Optional[Callable] = None,
            position_offset: int = 0, layout=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (logits [B, S, V] float32, aux_loss); with
    ``layout`` the vocab-sharded logits gathered over tp."""
    x, aux = hidden_states(params, tokens, cfg, attention_fn,
                           position_offset, layout)
    logits = x.float() @ _unembed(params, cfg, layout).float()
    if layout is not None:
        logits = layout.gather(logits, "tp", -1)
    return logits, aux


def _chunk_nll(x_c, t_c, unembed):
    logits = x_c.float() @ unembed.float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, t_c[..., None])[..., 0].sum()


def _chunk_nll_tp(x_c, t_c, unembed, layout):
    """``_chunk_nll`` of vocab-sharded logits (this rank's [V/tp]
    columns): the row max and the summed exponentials are reduced over
    tp, and the target's logit comes from the rank that holds it. The
    max only steadies the exponentials (its gradient cancels), so it is
    taken outside autograd."""
    logits = x_c.float() @ unembed.float()
    cols = logits.shape[-1]
    m = layout.pmax(logits.max(dim=-1).values, "tp")
    sumexp = layout.psum(torch.exp(logits - m[..., None]).sum(-1), "tp")
    local = t_c - layout.tp_rank * cols
    owned = (local >= 0) & (local < cols)
    target = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    target = layout.psum(target * owned, "tp")
    return (m + torch.log(sumexp) - target).sum()


def token_nll_sum(x: torch.Tensor, targets: torch.Tensor,
                  params: Dict[str, Any], cfg: ModelConfig,
                  layout=None) -> torch.Tensor:
    """Summed next-token cross entropy of final hidden states x [B, S, H]
    against targets [B, S]; vocab-parallel under ``layout``'s tp.

    When ``cfg.logits_chunk`` divides the sequence, the vocab projection
    and log-softmax run one sequence chunk at a time under checkpoint, so
    the fp32 [B, S, V] logits never materialize; the backward recomputes
    one [B, C, V] chunk at a time."""
    unembed = _unembed(params, cfg, layout)
    nll = (functools.partial(_chunk_nll_tp, layout=layout)
           if layout is not None and layout.tp > 1 else _chunk_nll)
    s = x.shape[1]
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
                nll, x[:, c:c + chunk], targets[:, c:c + chunk],
                unembed, use_reentrant=False)
        return total
    return nll(x, targets, unembed)


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross entropy over tokens[:, :-1] -> tokens[:, 1:]
    (mean over tokens, ``token_nll_sum``), plus 0.01 x the MoE aux
    loss."""
    x, aux = hidden_states(params, tokens[:, :-1], cfg, attention_fn)
    b, s, _ = x.shape
    return token_nll_sum(x, tokens[:, 1:], params, cfg) / (b * s) \
        + 0.01 * aux
