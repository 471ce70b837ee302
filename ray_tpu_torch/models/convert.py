"""Weights of the JAX package's model, as the port's parameters.

``params_from_jax`` takes the pytree ``ray_tpu.models.transformer.
init_params`` returns, with its leaves already turned into numpy arrays
(layers stacked on axis 0), and returns the port's parameter dict: same
keys, same shapes, same values, on ``device``. Given the same weights
both packages compute the same function, which is what the parity tests
hold them to. bfloat16 leaves are carried bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import ModelConfig

_NORMS = ("final_norm", "attn_norm", "mlp_norm")


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
    layers_np = params_np["layers"]
    if "moe" in layers_np:
        raise NotImplementedError(
            "MoE layers are not ported to ray_tpu_torch yet")

    def conv(name, array):
        dtype = torch.float32 if name in _NORMS else cfg.dtype
        return _tensor(array, dtype, device)

    params: Dict[str, Any] = {
        name: conv(name, arr) for name, arr in params_np.items()
        if name != "layers"}
    params["layers"] = {name: conv(name, arr)
                        for name, arr in layers_np.items()}
    return params
