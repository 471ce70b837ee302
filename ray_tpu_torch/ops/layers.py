"""Elementwise / normalization building blocks.

Port of ``ray_tpu/ops/layers.py`` as plain torch: the JAX package has no
kernel here either (XLA fuses these into the surrounding matmuls), and
the hot op with real tiling needs is attention (ops/attention.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * weight.to(torch.float32)).to(dtype)


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     device=None):
    """cos/sin tables [max_seq, head_dim/2] in float32 on ``device``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)  # [S, D/2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               position_offset: int = 0) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [max_seq, D/2] (sliced by position)."""
    s = x.shape[1]
    c = cos[position_offset:position_offset + s]
    sn = sin[position_offset:position_offset + s]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    c = c[None, :, None, :]
    sn = sn[None, :, None, :]
    out = torch.cat([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x@w_gate) * (x@w_up) @ w_down."""
    gate = F.silu(x @ w_gate)
    up = x @ w_up
    return (gate * up) @ w_down
