"""Inference entry for the model family.

Port of ``ray_tpu/models/training.py::build_forward`` without a mesh.
The train step, optimizer, sharding rules and pipeline step wait for the
training slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import transformer as tfm


def build_forward(cfg: tfm.ModelConfig, device=None,
                  attention_fn: Optional[Callable] = None) -> Callable:
    """Inference forward ``fwd(params, tokens) -> logits [B, S, V] f32``
    on ``device`` (CUDA unless the caller asks for the CPU). Tokens are
    moved to the device; no autograd graph is kept. ``attention_fn``
    (default: the flash-attention kernel path) swaps the attention."""
    device = resolve_device(device)

    @torch.no_grad()
    def fwd(params, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        logits, _ = tfm.forward(params, tokens, cfg, attention_fn)
        return logits

    return fwd
