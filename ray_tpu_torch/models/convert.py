"""Weights of the JAX package's models, as the port's parameters.

``params_from_jax`` takes the pytree ``ray_tpu.models.transformer.
init_params`` returns, with its leaves already turned into numpy arrays
(layers stacked on axis 0, the MoE weights nested under ``layers.moe``),
and returns the port's parameter dict: same keys, same shapes, same
values, on ``device``. ``vit_params_from_jax`` does the same for
``ray_tpu.models.vision.init_params`` (blocks a list of dicts). Given the
same weights both packages compute the same function, which is what the
parity tests hold them to. bfloat16 leaves are carried bit for bit.
``local_params`` cuts a full tree to a mesh rank's shards;
``checkpoint_state`` and ``train_state`` turn a rank's train state into
the DTensor tree ``models/checkpoint.py`` saves and restores across
mesh layouts, and back.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import ModelConfig
from ray_tpu_torch.models.vision import ViTConfig

# leaves the transformer keeps in float32 whatever cfg.dtype is
_FP32 = ("final_norm", "attn_norm", "mlp_norm", "router")


def _tensor(array, dtype: torch.dtype, device) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        t = torch.from_numpy(array.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(array))  # a writable copy
    return t.to(device=device, dtype=dtype)


def params_from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """JAX pytree of numpy leaves -> the port's params on ``device``."""
    device = resolve_device(device)

    def conv(tree):
        return {name: conv(value) if isinstance(value, dict)
                else _tensor(value, torch.float32 if name in _FP32
                             else cfg.dtype, device)
                for name, value in tree.items()}

    return conv(params_np)


def vit_params_from_jax(params_np: Dict[str, Any], cfg: ViTConfig,
                        device=None) -> Dict[str, Any]:
    """JAX ViT pytree of numpy leaves -> the port's ViT params on
    ``device``; every leaf, norms included, in ``cfg.dtype``."""
    device = resolve_device(device)
    params: Dict[str, Any] = {
        name: _tensor(value, cfg.dtype, device)
        for name, value in params_np.items() if name != "blocks"}
    params["blocks"] = [{name: _tensor(value, cfg.dtype, device)
                         for name, value in block.items()}
                        for block in params_np["blocks"]]
    return params


def local_params(params: Dict[str, Any], shardings: Dict[str, Any],
                 mesh) -> Dict[str, Any]:
    """This rank's shard of a full parameter tree on ``mesh``: each leaf
    cut by its placements (``models/training.py::param_shardings``), the
    shard a device of the JAX package's mesh holds of the same weights
    (a pipeline stage's slice of the layer stack; a replicated leaf
    whole)."""
    from ray_tpu_torch.models.training import map_tree
    from ray_tpu_torch.parallel.mesh import local_shard

    return map_tree(lambda x, pl: local_shard(x, pl, mesh), params,
                    shardings)


def checkpoint_state(state: Dict[str, Any], shardings: Any = None,
                     mesh=None) -> Dict[str, Any]:
    """A train state ``{"params": ..., "opt_state": ..., ...}`` in the
    form ``models/checkpoint.py`` saves and restores: ``ClippedAdamW``'s
    ``mu`` and ``nu`` lists (``tree_leaves(params)`` order) as trees
    shaped like the parameters, so that they pair by name whatever the
    order of a tree's keys; and, with ``mesh``, each parameter and moment
    a DTensor of its placements (``shardings``:
    ``models/training.py::param_shardings``) sharing this rank's
    storage, which is what restores across mesh layouts. Other leaves
    stay as they are. ``train_state`` is the inverse."""
    from ray_tpu_torch.models.checkpoint import _dtensor_cls
    from ray_tpu_torch.models.training import map_tree

    def wrap(tree):
        if mesh is None:
            return tree
        return map_tree(lambda x, pl: _dtensor_cls().from_local(
            x.detach(), mesh, pl, run_check=False), tree, shardings)

    out = dict(state)
    out["params"] = wrap(state["params"])
    if "opt_state" in state:
        opt = dict(state["opt_state"])
        for key in ("mu", "nu"):
            leaves = iter(opt[key])
            opt[key] = wrap(map_tree(lambda _: next(leaves),
                                     state["params"]))
        out["opt_state"] = opt
    return out


def train_state(saved: Dict[str, Any]) -> Dict[str, Any]:
    """``checkpoint_state``'s inverse: each DTensor as this rank's local
    tensor and the moments as lists in ``tree_leaves(params)`` order,
    ready for the train step."""
    from ray_tpu_torch.models.checkpoint import _dtensor_cls
    from ray_tpu_torch.models.training import tree_leaves

    def local(tree):
        if isinstance(tree, dict):
            return {k: local(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(local(v) for v in tree)
        return tree.to_local() if isinstance(tree, _dtensor_cls()) else tree

    out = local(saved)
    if "opt_state" in out:
        for key in ("mu", "nu"):
            out["opt_state"][key] = tree_leaves(out["opt_state"][key])
    return out
