"""Weights of the JAX package's models, as the port's parameters.

``params_from_jax`` takes the pytree ``ray_tpu.models.transformer.
init_params`` returns, with its leaves already turned into numpy arrays
(layers stacked on axis 0, the MoE weights nested under ``layers.moe``),
and returns the port's parameter dict: same keys, same shapes, same
values, on ``device``. ``vit_params_from_jax`` does the same for
``ray_tpu.models.vision.init_params`` (blocks a list of dicts). Given the
same weights both packages compute the same function, which is what the
parity tests hold them to. bfloat16 leaves are carried bit for bit.
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
