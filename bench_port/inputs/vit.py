"""A Vision Transformer (the paper's Table 1 keys): weights in the
program's layout (``blocks`` a list of dicts; every leaf in the
configuration's type) and batches of images with class labels."""

from __future__ import annotations

import torch

from bench_port import work
from bench_port.weights import generator, make_tree


def dtype(conf: dict) -> torch.dtype:
    return getattr(torch, conf["torch_dtype"])


def weight_specs(conf: dict) -> list:
    d, mlp = conf["hidden_size"], conf["mlp_size"]
    patch_dim = conf["patch_size"] ** 2 * conf["channels"]
    tokens = (conf["image_size"] // conf["patch_size"]) ** 2 + 1
    dt = dtype(conf)
    std = d ** -0.5
    specs = [
        (("patch_w",), (patch_dim, d), patch_dim ** -0.5, dt),
        (("patch_b",), (d,), "zeros", dt),
        (("pos",), (tokens, d), conf["initializer_range"], dt),
        (("cls",), (d,), conf["initializer_range"], dt),
        (("norm_out",), (d,), "ones", dt),
        (("head_w",), (d, conf["num_classes"]), std, dt),
        (("head_b",), (conf["num_classes"],), "zeros", dt),
    ]
    for i in range(conf["num_layers"]):
        b = ("blocks", str(i))
        specs += [
            (b + ("norm1",), (d,), "ones", dt),
            (b + ("norm2",), (d,), "ones", dt),
            (b + ("wqkv",), (d, 3 * d), std, dt),
            (b + ("wo",), (d, d), std, dt),
            (b + ("w1",), (d, mlp), std, dt),
            (b + ("w2",), (mlp, d), mlp ** -0.5, dt),
        ]
    return specs


def make_weights(conf: dict, seed: int, device) -> dict:
    tree = make_tree(weight_specs(conf), seed, device)
    tree["blocks"] = [tree["blocks"][str(i)]
                      for i in range(conf["num_layers"])]
    return tree


def make_batch(conf: dict, traffic: dict, seed: int, step: int, device):
    """Step ``step``'s (images [batch, H, W, C] fp32, labels [batch])."""
    g = generator(seed, f"batch/{step}", device)
    size = conf["image_size"]
    images = torch.randn((traffic["batch"], size, size, conf["channels"]),
                         generator=g, device=device)
    labels = torch.randint(0, conf["num_classes"], (traffic["batch"],),
                           generator=g, device=device)
    return images, labels


def tokens_per_step(conf: dict, traffic: dict) -> int:
    """Positions a step trains: the patches and the class token."""
    return traffic["batch"] * (
        (conf["image_size"] // conf["patch_size"]) ** 2 + 1)


def train_flops(conf: dict, traffic: dict) -> int:
    return work.vit_train_flops(conf, traffic["batch"])
