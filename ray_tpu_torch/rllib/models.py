"""Model catalog — network families for RL policies.

Port of ray_tpu/rllib/models.py (reference: rllib/models/, ModelCatalog
+ TF/Torch FCNet, VisionNet, RNN wrappers): PyTorch functional models
chosen by observation shape, as the reference's catalog dispatches:

  - fully-connected (FCNet)              flat observations
  - convolutional (VisionNetwork)        image observations [H, W, C]
  - recurrent (GRU wrapper)              sequence policies (a loop over
                                         time: the JAX package's
                                         ``lax.scan``)

Every model is an ``(init(generator, device=None) -> params,
apply(params, x) -> out)`` pair, with parameters in the JAX package's
layout (``vision_net``'s convs HWIO, its activations NHWC at the
interface), so a tree from either package's ``init`` serves either
``apply``. ``init`` draws on the CPU from ``generator`` (same
distributions as the JAX package, other values) and places the tree on
``device``: CUDA unless the caller asks for the CPU.

Precision on the card: the dense layers are float32 matmuls, which
PyTorch runs without TF32 by default (``torch.backends.cuda.matmul.
allow_tf32`` is False). The convolutions go through cuDNN, whose
default is ``torch.backends.cudnn.allow_tf32 = True``: ``vision_net``'s
convs round their float32 inputs to TF32 (10 mantissa bits) on the
card, so it agrees with the CPU to about 1e-3 relative, not 1e-6. This
module sets no global flag; a caller who wants full float32 convs sets
``allow_tf32`` itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device

Model = Tuple[Callable, Callable]  # (init, apply)


def _normal(generator, shape, scale: float, device) -> torch.Tensor:
    w = torch.randn(shape, generator=generator) * np.float32(scale)
    return w.to(resolve_device(device)).requires_grad_(True)


def _zeros(n: int, device) -> torch.Tensor:
    return torch.zeros(n, device=resolve_device(device), requires_grad=True)


# ------------------------------------------------------------------ dense
def fcnet(sizes: Sequence[int], activation=torch.tanh) -> Model:
    """FCNet (reference: rllib/models/tf/fcnet.py)."""

    def init(generator: torch.Generator, device=None):
        return [{"w": _normal(generator, (din, dout),
                              np.sqrt(2.0 / din), device),
                 "b": _zeros(dout, device)}
                for din, dout in zip(sizes[:-1], sizes[1:])]

    def apply(params, x):
        for i, layer in enumerate(params):
            x = x @ layer["w"] + layer["b"]
            if i < len(params) - 1:
                x = activation(x)
        return x

    return init, apply


# ------------------------------------------------------------------- conv
def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` along one axis: out = ceil(size /
    stride), total = max((out - 1) * stride + kernel - size, 0), total // 2
    before and the rest after (asymmetric when total is odd). PyTorch's
    ``padding="same"`` refuses stride > 1, so the convs pad explicitly."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def vision_net(input_shape: Tuple[int, int, int], num_outputs: int,
               filters: Sequence[Tuple[int, int, int]] = (
                   (16, 4, 2), (32, 4, 2), (64, 3, 1)),
               hidden: int = 256) -> Model:
    """VisionNetwork (reference: rllib/models/tf/visionnet.py): conv
    stack then dense head. Input and parameters in the JAX package's
    layouts (x [B, H, W, C], conv weights HWIO); the convs run in NCHW
    (cuDNN's layout) and the activations go back to NHWC before the
    flatten, so ``fc``'s rows meet the features in the JAX package's
    order."""

    def init(generator: torch.Generator, device=None):
        h, w, c_in = input_shape
        params = {"convs": []}
        for c_out, k, s in filters:
            fan_in = k * k * c_in
            params["convs"].append({
                "w": _normal(generator, (k, k, c_in, c_out),
                             np.sqrt(2.0 / fan_in), device),
                "b": _zeros(c_out, device),
            })
            h = -(-h // s)
            w = -(-w // s)
            c_in = c_out
        flat = h * w * c_in
        params["fc"] = {"w": _normal(generator, (flat, hidden),
                                     np.sqrt(2.0 / flat), device),
                        "b": _zeros(hidden, device)}
        params["head"] = {"w": _normal(generator, (hidden, num_outputs),
                                       np.sqrt(2.0 / hidden), device),
                          "b": _zeros(num_outputs, device)}
        return params

    strides = [s for _c, _k, s in filters]  # static, not in the tree

    def apply(params, x):
        # x: [B, H, W, C] float
        x = x.permute(0, 3, 1, 2)
        for conv, stride in zip(params["convs"], strides):
            k = conv["w"].shape[0]
            top, bottom = same_padding(x.shape[2], k, stride)
            left, right = same_padding(x.shape[3], k, stride)
            x = F.conv2d(F.pad(x, (left, right, top, bottom)),
                         conv["w"].permute(3, 2, 0, 1), conv["b"],
                         stride=stride)
            x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(x @ params["fc"]["w"] + params["fc"]["b"])
        return x @ params["head"]["w"] + params["head"]["b"]

    return init, apply


# -------------------------------------------------------------- recurrent
def gru_net(input_dim: int, hidden: int, num_outputs: int) -> Model:
    """Recurrent policy net (reference: rllib/models/tf/recurrent_net.py).
    The cell is the JAX package's: r = σ(xr + hr), z = σ(xz + hz),
    n = tanh(xn + r·hn) with the bias on the input side only (no hidden
    bias), h' = (1 − z)·n + z·h; the sequence is a loop over time."""

    def init(generator: torch.Generator, device=None):
        scale_x = np.sqrt(1.0 / input_dim)
        scale_h = np.sqrt(1.0 / hidden)
        return {
            "wx": _normal(generator, (input_dim, 3 * hidden), scale_x,
                          device),
            "wh": _normal(generator, (hidden, 3 * hidden), scale_h, device),
            "b": _zeros(3 * hidden, device),
            "head_w": _normal(generator, (hidden, num_outputs), scale_h,
                              device),
            "head_b": _zeros(num_outputs, device),
            "h0": _zeros(hidden, device),
        }

    def cell(params, h, x):
        gates_x = x @ params["wx"]
        gates_h = h @ params["wh"]
        xr, xz, xn = torch.chunk(gates_x + params["b"], 3, dim=-1)
        hr, hz, hn = torch.chunk(gates_h, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h

    def apply(params, x, h_init=None):
        # x: [B, T, D] -> (outputs [B, T, O], final hidden [B, H])
        batch = x.shape[0]
        h = (params["h0"].expand(batch, params["h0"].shape[0])
             if h_init is None else h_init)
        outs = []
        for t in range(x.shape[1]):
            h = cell(params, h, x[:, t])
            outs.append(h @ params["head_w"] + params["head_b"])
        return torch.stack(outs, dim=1), h

    return init, apply


# ----------------------------------------------------------------- catalog
class ModelCatalog:
    """Pick a model family from the observation shape (reference:
    rllib/models/catalog.py ModelCatalog.get_model_v2)."""

    @staticmethod
    def get_model(obs_shape: Tuple[int, ...], num_outputs: int,
                  config: Dict = None) -> Model:
        config = config or {}
        if len(obs_shape) == 3:
            return vision_net(obs_shape, num_outputs,
                              filters=config.get(
                                  "conv_filters",
                                  ((16, 4, 2), (32, 4, 2), (64, 3, 1))),
                              hidden=config.get("post_fcnet_hiddens", 256))
        if config.get("use_rnn"):
            return gru_net(obs_shape[0],
                           config.get("rnn_hidden", 128), num_outputs)
        hiddens = tuple(config.get("fcnet_hiddens", (64, 64)))
        return fcnet((obs_shape[0], *hiddens, num_outputs))
