"""Train steps, optimizer and inference entry for the model family.

Port of ``ray_tpu/models/training.py``:

  make_optimizer     AdamW behind a global-norm clip, with optax's
                     semantics (``optax.chain(clip_by_global_norm,
                     adamw)``);
  build_train_step   (step, init_fn): ``step(params, opt_state, tokens)``
                     takes one optimizer step on the next-token loss and
                     returns (params, opt_state, {"loss", "grad_norm"});
                     on one device, or with ``mesh=`` on each rank of a
                     dp x sp x tp DeviceMesh (ring or Ulysses attention
                     over sp, heads/mlp/vocab over tp, experts over dp,
                     and with ``fsdp=True`` the parameters' hidden axis
                     and AdamW's moments over dp);
  build_pipeline_train_step
                     pp > 1: each rank holds its stage's slice of the
                     layer stack and runs the GPipe schedule
                     (parallel/pipeline.py); embed/unembed replicated
                     over pp; dp x pp x tp;
  build_forward      the inference forward, on one device or with
                     ``mesh=`` on each rank's [B/dp, S/sp] window.

Every rank of a mesh runs the same program on its local shard, the JAX
package's GSPMD and shard_map regions made whole-program: a step takes
the full [B, S + 1] tokens on every rank and keeps its own
[B/dp, S/sp + 1] window, and its parameters are its shards
(``param_shardings``, ``models/convert.py::local_params``). The layers
issue the collectives GSPMD would (``parallel.mesh.RankLayout``). The
loss a rank differentiates is its share of the global loss: its tokens'
summed cross entropy over the global token count plus its share of the
MoE aux loss, divided by the tp ranks and pp stages that compute the
same value; each collective's backward is its transpose, and the
gradient of a parameter replicated over an axis is the sum of the
ranks' along it. MoE on the pipeline raises, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    RankLayout,
    fsdp_rules,
    shard_map,
    sharding_for,
)

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
               state: Dict[str, Any],
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step in place on ``params`` and ``state``; ``grads`` in
        ``tree_leaves(params)`` order. Returns the pre-clip global norm
        (a 0-dim float32 tensor on the parameters' device). ``norm``:
        that norm, when ``params`` and ``grads`` are one rank's shard of
        the whole (a pipeline stage's)."""
        leaves = tree_leaves(params)
        if norm is None:
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


def map_tree(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts and lists of equal
    structure (a tuple is a leaf: a logical-axes record)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [map_tree(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def param_shardings(cfg: tfm.ModelConfig, mesh,
                    fsdp: bool = False) -> Dict[str, Any]:
    """The parameters' DTensor placements on ``mesh`` (one per mesh
    dimension, per leaf) from ``tfm.logical_axes`` and the rule table."""
    rules = fsdp_rules() if fsdp else DEFAULT_RULES
    return map_tree(lambda ax: sharding_for(mesh, ax, rules),
                    tfm.logical_axes(cfg))


def _leaf_placements(params, shardings) -> List[tuple]:
    """Each parameter's placements, in ``tree_leaves(params)`` order
    (paired by key: a tree converted from the JAX package's has its keys
    in another order than ``logical_axes``)."""
    out: List[tuple] = []
    map_tree(lambda _, pl: out.append(pl), params, shardings)
    return out


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _check_mesh(cfg: tfm.ModelConfig, mesh, allowed: Tuple[str, ...],
                sp_strategy: str = "ring") -> None:
    """Raises for a mesh the model cannot take: tp not dividing heads, sp
    not dividing a rank's heads under Ulysses, and axes past ``allowed``
    with more than one rank."""
    sizes = _sizes(mesh)
    tp, sp = sizes.get("tp", 1), sizes.get("sp", 1)
    if cfg.heads % tp:
        raise ValueError(f"tp = {tp} does not divide heads = {cfg.heads}")
    if sp_strategy == "ulysses" and (cfg.heads // tp) % sp:
        raise ValueError(f"ulysses needs sp = {sp} to divide a rank's "
                         f"heads (heads / tp = {cfg.heads // tp})")
    for name, n in sizes.items():
        if n > 1 and name not in allowed:
            raise NotImplementedError(
                f"{name} = {n} on this path (it takes {allowed})")


def _make_attention_fn(mesh, cfg: tfm.ModelConfig,
                       sp_strategy: str = "ring"):
    """Sequence-parallel attention over sp when the mesh has an sp axis
    > 1, else the local flash kernel. Two sp strategies: "ring" (K/V
    rotation, O(1) memory, parallel/ring_attention.py) and "ulysses"
    (all-to-all head/seq swap, parallel/ulysses.py, flash attention on
    the swapped shards) — pick ulysses when heads >> sp. The function
    takes this rank's [B/dp, S/sp, H, D] shards and binds the mesh
    itself, so a checkpointed layer's recompute finds it."""
    from ray_tpu_torch.ops.attention import flash_attention

    if _sizes(mesh).get("sp", 1) == 1:
        return functools.partial(flash_attention, causal=True)
    if sp_strategy == "ulysses":
        from ray_tpu_torch.parallel.ulysses import ulysses_attention

        sp_body = functools.partial(ulysses_attention, axis_name="sp",
                                    causal=True)
    elif sp_strategy == "ring":
        from ray_tpu_torch.parallel.ring_attention import ring_attention

        sp_body = functools.partial(ring_attention, axis_name="sp",
                                    causal=True)
    else:
        raise ValueError(f"unknown sp_strategy {sp_strategy!r}")

    def attn(q, k, v):
        with shard_map(mesh):
            return sp_body(q, k, v)

    return attn


def _mesh_device(mesh, device):
    return resolve_device(mesh.device_type if device is None else device)


def _window(tokens: torch.Tensor, mesh, extra: int
            ) -> Tuple[torch.Tensor, int]:
    """This rank's [B/dp, S/sp + extra] window of tokens [B, S + extra]
    and the sequence position it starts at."""
    sizes = _sizes(mesh)
    dp, sp = sizes.get("dp", 1), sizes.get("sp", 1)
    d = mesh.get_local_rank("dp") if dp > 1 else 0
    r = mesh.get_local_rank("sp") if sp > 1 else 0
    b, s = tokens.shape[0], tokens.shape[1] - extra
    if b % dp or s % sp:
        raise ValueError(f"tokens {tuple(tokens.shape)}: batch must divide "
                         f"by dp = {dp} and sequence by sp = {sp}")
    b, s = b // dp, s // sp
    return tokens[d * b:(d + 1) * b, r * s:(r + 1) * s + extra], r * s


def _axes_where(placements, mesh, sharded: bool) -> Tuple[str, ...]:
    """The mesh axes with more than one rank that shard (``sharded``) or
    replicate the leaf of ``placements``."""
    return tuple(name for name, n, p in zip(mesh.mesh_dim_names, mesh.shape,
                                            placements)
                 if n > 1 and p.is_shard() == sharded)


@torch.no_grad()
def _reduce_grads(grads: List[torch.Tensor], placements: List[tuple],
                  mesh) -> List[torch.Tensor]:
    """Each gradient summed over the axes its parameter is replicated on
    (one fp32 all-reduce per set of axes), in its parameter's dtype."""
    from ray_tpu_torch.collective.api import ici

    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, pl in enumerate(placements):
        groups.setdefault(_axes_where(pl, mesh, False), []).append(i)
    out = list(grads)
    with shard_map(mesh):
        for axes, idx in groups.items():
            if not axes:
                continue
            flat = torch.cat([grads[i].float().reshape(-1) for i in idx])
            flat = ici.allreduce(flat, axes)
            for i, part in zip(idx, flat.split(
                    [grads[i].numel() for i in idx])):
                out[i] = part.reshape(grads[i].shape).to(grads[i].dtype)
    return out


@torch.no_grad()
def _global_norm(grads: List[torch.Tensor], placements: List[tuple],
                 mesh) -> torch.Tensor:
    """The norm of the whole gradient: each shard's squares summed over
    the axes that shard it."""
    from ray_tpu_torch.collective.api import ici

    parts: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, pl in zip(grads, placements):
        axes = _axes_where(pl, mesh, True)
        parts[axes] = parts.get(axes, 0) + g.float().square().sum()
    total = 0
    with shard_map(mesh):
        for axes, sq in parts.items():
            total = total + (ici.allreduce(sq, axes) if axes else sq)
    return torch.sqrt(total)


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    # a weight no layer uses gets zeros, as lax.cond gives in the JAX
    # step (e.g. the dense MLP when every layer is a MoE layer)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, torch.autograd.grad(
                loss, leaves, allow_unused=True))]


def build_train_step(cfg: tfm.ModelConfig, device=None,
                     optimizer: Optional[ClippedAdamW] = None, *,
                     mesh=None, fsdp: bool = False,
                     sp_strategy: str = "ring"
                     ) -> Tuple[Callable, Callable]:
    """Train step on ``device`` (CUDA unless the caller asks for the
    CPU), or on each rank of ``mesh`` (a dp x sp x tp DeviceMesh; its
    device type unless ``device`` is given) -> (step, init_fn).

    ``init_fn(generator=None)`` -> (params, opt_state), weights drawn by
    ``tfm.init_params`` (on a mesh every rank draws the same from the
    same seed and keeps its shard). ``step(params, opt_state, tokens
    [B, S+1])`` -> (params, opt_state, {"loss", "grad_norm"}), both 0-dim
    float32 tensors: the loss before the update and the global grad norm
    before the clip. On a mesh each rank takes its window of the tokens
    and its shards of the parameters (``param_shardings(cfg, mesh,
    fsdp)``): the sequence-parallel attention runs over sp
    (``sp_strategy``), heads, mlp columns and the vocab over tp, experts
    over dp, and with ``fsdp`` the parameters' hidden axis over dp, each
    layer gathering its weights at use (AdamW's moments stay shards:
    ZeRO's 1/dp). The loss and its gradients equal the unsharded step's.
    Parameters and optimizer state are updated IN PLACE (the returned
    objects are the ones passed in), which keeps one copy of the weights
    on the card where the JAX step donates its buffers. A mesh step's
    ``step.loss_and_grads(params, tokens)`` is the step without the
    update: (the loss, this rank's reduced gradients in
    ``tree_leaves(params)`` order, the global grad norm)."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True shards over a mesh's dp axis: pass "
                         "mesh=")
    device = (resolve_device(device) if mesh is None
              else _mesh_device(mesh, device))
    optimizer = optimizer or make_optimizer()

    if mesh is None:
        def init_fn(generator: Optional[torch.Generator] = None):
            params = tfm.init_params(cfg, generator, device=device)
            return params, optimizer.init(params)

        def step(params, opt_state, tokens):
            tokens = torch.as_tensor(tokens, device=device).long()
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = tfm.loss_fn(params, tokens, cfg)
            grad_norm = optimizer.update(params, _grads(loss, leaves),
                                         opt_state)
            return params, opt_state, {"loss": loss.detach(),
                                       "grad_norm": grad_norm}

        return step, init_fn

    _check_mesh(cfg, mesh, ("dp", "sp", "tp"), sp_strategy)
    attention_fn = _make_attention_fn(mesh, cfg, sp_strategy)
    shardings = param_shardings(cfg, mesh, fsdp)
    layout = RankLayout.of(mesh, fsdp)
    data_axes = tuple(a for a in ("dp", "sp") if _sizes(mesh)[a] > 1)
    init_fn = _mesh_init(cfg, mesh, device, shardings, optimizer)

    def loss_and_grads(params, tokens):
        from ray_tpu_torch.collective.api import ici

        tokens = torch.as_tensor(tokens, device=device).long()
        window, offset = _window(tokens, mesh, 1)
        n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        x, aux = tfm.hidden_states(params, window[:, :-1], cfg,
                                   attention_fn, offset, layout)
        loss = tfm.token_nll_sum(x, window[:, 1:], params, cfg,
                                 layout) / n_tokens + 0.01 * aux
        placements = _leaf_placements(params, shardings)
        # the tp ranks compute the same loss: each differentiates 1/tp
        grads = _reduce_grads(_grads(loss / layout.tp, leaves), placements,
                              mesh)
        with shard_map(mesh):
            loss = ici.allreduce(loss.detach(), data_axes)
        return loss, grads, _global_norm(grads, placements, mesh)

    def mesh_step(params, opt_state, tokens):
        loss, grads, norm = loss_and_grads(params, tokens)
        grad_norm = optimizer.update(params, grads, opt_state, norm=norm)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    mesh_step.loss_and_grads = loss_and_grads
    return mesh_step, init_fn


def _mesh_init(cfg: tfm.ModelConfig, mesh, device, shardings,
               optimizer: ClippedAdamW) -> Callable:
    """``init_fn`` of a mesh step: the full weights drawn on every rank,
    this rank's shards kept (``models/convert.py::local_params``), and
    the optimizer's moments shaped like them."""
    from ray_tpu_torch.models.convert import local_params

    def init_fn(generator: Optional[torch.Generator] = None):
        params = local_params(tfm.init_params(cfg, generator, device=device),
                              shardings, mesh)
        return params, optimizer.init(params)

    return init_fn


def build_forward(cfg: tfm.ModelConfig, device=None,
                  attention_fn: Optional[Callable] = None, *,
                  mesh=None, sp_strategy: str = "ring") -> Callable:
    """Inference forward ``fwd(params, tokens) -> logits [B, S, V] f32``
    on ``device`` (CUDA unless the caller asks for the CPU). Tokens are
    moved to the device; no autograd graph is kept. ``attention_fn``
    (default: the flash-attention kernel path) swaps the attention.

    With ``mesh`` (dp x sp x tp; its device type unless ``device`` is
    given) every rank takes the full tokens and its parameter shards
    (``param_shardings(cfg, mesh)``) and returns the full-vocab logits
    of its own [B/dp, S/sp] window (gathered over tp), attention over sp
    by ``sp_strategy``."""
    layout = None
    if mesh is not None:
        _check_mesh(cfg, mesh, ("dp", "sp", "tp"), sp_strategy)
        device = _mesh_device(mesh, device)
        attention_fn = attention_fn or _make_attention_fn(mesh, cfg,
                                                          sp_strategy)
        layout = RankLayout.of(mesh)
    else:
        device = resolve_device(device)

    @torch.no_grad()
    def fwd(params, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        offset = 0
        if mesh is not None:
            tokens, offset = _window(tokens, mesh, 0)
        logits, _ = tfm.forward(params, tokens, cfg, attention_fn, offset,
                                layout)
        return logits

    return fwd


# -- pipeline path -----------------------------------------------------------


def build_pipeline_train_step(cfg: tfm.ModelConfig, mesh, *,
                              num_microbatches: Optional[int] = None,
                              optimizer: Optional[ClippedAdamW] = None,
                              ) -> Tuple[Callable, Callable]:
    """pp > 1: layer stack sharded over ``pp``, GPipe schedule
    (parallel/pipeline.py); embed/unembed replicated across stages, dp
    shards the batch, tp the heads, mlp columns and vocab as in
    ``build_train_step``. -> (step, init_fn) as ``build_train_step``'s, on
    each rank of ``mesh``: ``init_fn`` draws the full weights and keeps
    this rank's stage (``models/convert.py::local_params``), and ``step``
    takes the full tokens. Each stage runs its ``layers/pp`` layers (the
    flash-attention kernels; each layer under remat when ``cfg.remat``)
    on every tick. ``step.loss_and_grads(params, tokens)`` is the step
    without the update: (the loss, this rank's reduced gradients in
    ``tree_leaves(params)`` order, the global grad norm)."""
    from ray_tpu_torch.collective.api import ici
    from ray_tpu_torch.ops.layers import rms_norm, rope_frequencies
    from ray_tpu_torch.parallel.pipeline import pipeline_spmd

    pp = _sizes(mesh)["pp"]
    if cfg.layers % pp:
        raise ValueError("pp must divide layers")
    # The GPipe stage_fn carries only the hidden activations, so the MoE
    # router's load-balancing aux loss cannot flow to the loss; fail
    # loudly rather than silently train without router balancing.
    if cfg.num_experts:
        raise ValueError(
            "MoE (num_experts > 0) is not supported on the pipeline path; "
            "use build_train_step for MoE configs")
    _check_mesh(cfg, mesh, ("dp", "pp", "tp"))
    optimizer = optimizer or make_optimizer()
    num_microbatches = num_microbatches or pp
    device = _mesh_device(mesh, None)
    shardings = param_shardings(cfg, mesh)  # layers axis -> pp
    layout = RankLayout.of(mesh)
    n_local = cfg.layers // pp
    dp_axes = ("dp",) if _sizes(mesh)["dp"] > 1 else ()
    init_fn = _mesh_init(cfg, mesh, device, shardings, optimizer)

    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=device)

    def loss_and_grads(params, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        window, _ = _window(tokens, mesh, 1)
        n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        first = mesh.get_local_rank("pp") * n_local

        def stage_fn(stage_layers, x):
            return tfm.run_layers(x, stage_layers, cfg, cos, sin,
                                  first_layer=first, layout=layout)[0]

        with shard_map(mesh):
            x = tfm.embed_tokens(params, window[:, :-1], cfg, layout)
            x = pipeline_spmd(stage_fn, tfm.per_layer(params["layers"],
                                                      n_local),
                              x, "pp", num_microbatches)
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            loss = tfm.token_nll_sum(x, window[:, 1:], params, cfg,
                                     layout) / n_tokens
            # every stage and tp rank computes the same loss from the
            # replicated outputs: each differentiates its share of it
            placements = _leaf_placements(params, shardings)
            grads = _reduce_grads(_grads(loss / (pp * layout.tp), leaves),
                                  placements, mesh)
            loss = ici.allreduce(loss.detach(), dp_axes)
        return loss, grads, _global_norm(grads, placements, mesh)

    def step(params, opt_state, tokens):
        loss, grads, norm = loss_and_grads(params, tokens)
        grad_norm = optimizer.update(params, grads, opt_state, norm=norm)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    step.loss_and_grads = loss_and_grads
    return step, init_fn
