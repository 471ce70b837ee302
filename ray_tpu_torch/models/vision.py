"""Vision Transformer family, the image-model counterpart of the flagship
text transformer.

Port of ``ray_tpu/models/vision.py`` to plain functions on torch tensors,
with the JAX package's parameter layout (``blocks`` a list of dicts, so
``models/convert.py::vit_params_from_jax`` maps the two one to one) and
the same hot ops as the text model: non-causal ``ops.flash_attention``
(the hand-written Hopper kernels on CUDA) and bf16 matmuls by default.

    init_params(cfg, generator, device) -> params
    forward(params, images, cfg) -> logits [B, num_classes] float32
    loss_fn(params, images, labels, cfg) -> mean cross entropy

Sharding hints (``logical_axes``) wait for the mesh port.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    hidden: int = 384
    layers: int = 6
    heads: int = 6
    intermediate: int = 1536
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    pool: str = "cls"  # "cls" | "mean"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def debug(cls, **kw) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, num_classes=10, hidden=64,
                   layers=2, heads=4, intermediate=128, dtype=torch.float32,
                   **kw)

    @classmethod
    def base(cls) -> "ViTConfig":
        """ViT-B/16 (Dosovitskiy et al. 2020, Table 1)."""
        return cls(hidden=768, layers=12, heads=12, intermediate=3072)


def init_params(cfg: ViTConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Random weights with the JAX package's shapes, scales and dtypes,
    drawn from ``generator`` on ``device`` (CUDA unless the caller asks
    for the CPU; a missing generator is seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d = cfg.hidden
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
    scale = d ** -0.5

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(cfg.dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    params: Dict[str, Any] = {
        "patch_w": normal((patch_dim, d), patch_dim ** -0.5),
        "patch_b": full((d,), 0.0),
        "pos": normal((cfg.num_patches + 1, d), 0.02),
        "cls": normal((d,), 0.02),
        "norm_out": full((d,), 1.0),
        "head_w": normal((d, cfg.num_classes), scale),
        "head_b": full((cfg.num_classes,), 0.0),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        params["blocks"].append({
            "norm1": full((d,), 1.0),
            "norm2": full((d,), 1.0),
            "wqkv": normal((d, 3 * d), scale),
            "wo": normal((d, d), scale),
            "w1": normal((d, cfg.intermediate), scale),
            "w2": normal((cfg.intermediate, d), cfg.intermediate ** -0.5),
        })
    return params


def _layer_norm(x, weight, eps):
    """LayerNorm without bias in x's dtype, op for op as the JAX package
    writes it (F.layer_norm would compute in fp32 and round once)."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch_dim] without conv: a reshape and a
    permute; the projection is one matmul."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def forward(params: Dict[str, Any], images, cfg: ViTConfig,
            attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """images [B, H, W, C] float -> logits [B, num_classes] float32.
    ``attention_fn`` (default: non-causal ``flash_attention``, the kernel
    path on CUDA) swaps the attention."""
    if attention_fn is None:
        attention_fn = functools.partial(flash_attention, causal=False)
    images = torch.as_tensor(images, device=params["patch_w"].device)
    x = patchify(images.to(cfg.dtype), cfg)
    x = x @ params["patch_w"] + params["patch_b"]
    b = x.shape[0]
    seq = x.shape[1] + 1  # patches + CLS
    cls = params["cls"].expand(b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1) + params["pos"][None, :seq]
    for block in params["blocks"]:
        h = _layer_norm(x, block["norm1"], cfg.norm_eps)
        qkv = h @ block["wqkv"]
        s = qkv.shape[1]
        # the thirds of qkv are strided views; the kernels take
        # contiguous [B, S, H, D] tensors
        q, k, v = (t.reshape(b, s, cfg.heads, cfg.head_dim).contiguous()
                   for t in qkv.chunk(3, dim=-1))
        att = attention_fn(q, k, v).reshape(b, s, cfg.hidden)
        x = x + att @ block["wo"]
        h = _layer_norm(x, block["norm2"], cfg.norm_eps)
        x = x + F.gelu(h @ block["w1"], approximate="tanh") @ block["w2"]
    x = _layer_norm(x, params["norm_out"], cfg.norm_eps)
    pooled = x[:, 0] if cfg.pool == "cls" else x[:, 1:].mean(dim=1)
    return (pooled @ params["head_w"] + params["head_b"]).float()


def loss_fn(params: Dict[str, Any], images, labels, cfg: ViTConfig,
            attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """Mean cross entropy of ``forward``'s logits against int labels."""
    logits = forward(params, images, cfg, attention_fn)
    labels = torch.as_tensor(labels, device=logits.device).long()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None])[..., 0].mean()
