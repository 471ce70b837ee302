"""A ViT configuration through ``models/vision.py``. The port has no
train-step entry for it, so the step is user code: ``vision.loss_fn``,
autograd and ``ClippedAdamW.update`` (``make_optimizer``), as a user of
the library writes it; a change to the ViT step can only speed up what
this loop calls."""

from __future__ import annotations


def port_config(conf: dict):
    import torch

    from ray_tpu_torch.models.vision import ViTConfig

    cfg = ViTConfig(image_size=conf["image_size"],
                    patch_size=conf["patch_size"], channels=conf["channels"],
                    num_classes=conf["num_classes"],
                    hidden=conf["hidden_size"], layers=conf["num_layers"],
                    heads=conf["num_heads"], intermediate=conf["mlp_size"],
                    norm_eps=conf["layer_norm_eps"],
                    dtype=getattr(torch, conf["torch_dtype"]))
    if cfg.head_dim != conf["head_dim"]:
        raise ValueError(f"the port derives head dim {cfg.head_dim}, the "
                         f"configuration states {conf['head_dim']}")
    return cfg


def train_step(conf: dict, traffic: dict, device):
    import torch

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.models.training import make_optimizer, tree_leaves

    hp = traffic["optimizer"]
    opt = make_optimizer(**hp)
    cfg = port_config(conf)

    def run(params, state, batch):
        images, labels = batch
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = vision.loss_fn(params, images, labels, cfg)
        opt.update(params, torch.autograd.grad(loss, leaves), state)
        return loss.detach()

    def first_grads(state):
        return [mu.float() / (1 - hp["b1"]) for mu in state["mu"]]

    return run, opt.init, first_grads


def train_attention_calls(conf: dict, traffic: dict) -> list:
    s = (conf["image_size"] // conf["patch_size"]) ** 2 + 1
    shape = (traffic["batch"], s, s, conf["num_heads"], conf["head_dim"],
             False)
    n = conf["num_layers"]
    return [("fwd", *shape, n), ("dq", *shape, n), ("dkdv", *shape, n)]
