"""Where one train step spends its device time.

    python3 -m ray_tpu_torch.tools.profile_training [--model b1|moe|vit]
        [--steps N]

Builds the model on the card (random weights, seed 0): ``ModelConfig.b1``
(remat "full") on one seeded [8, 2049] token batch, the bench's MoE model
(``ModelConfig.moe_bench``) on [16, 2049], both through
``build_train_step``; or ViT-B/16 (``ViTConfig.base``) on 128 images,
``loss_fn`` and autograd and ``ClippedAdamW``. Takes two warm-up steps,
times N steps with CUDA events, then runs N more under ``torch.profiler``
and prints one JSON line: device time per step by kernel group (the
flash-attention forward and backward kernels, matrix products,
everything else), for the MoE model the matrix products split by the op
that ran them (``op_group_ms``: the fp32 dispatch/combine einsums, the
experts' GEMMs), the busiest kernels, the device's idle share of the
profiled window, tokens (or images) per second and peak device memory.
Needs CUDA (exits 2 without it) and fails if the profiler records no
device time.
"""

from __future__ import annotations

import argparse
import json
import sys

from ray_tpu_torch.tools.profile_serving import (
    MODELS,
    card_line,
    device_profile,
    moe_matmul_group,
)

TOKENS = {"b1": (8, 2049), "moe": (16, 2049)}  # [B, S + 1]
VIT_IMAGES = 128


def _text_step(model: str):
    """(one_step, units per step, unit, op_group) for b1 or moe."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_train_step

    cfg = (tfm.ModelConfig.b1() if model == "b1"
           else tfm.ModelConfig.moe_bench())
    step, init_fn = build_train_step(cfg, device="cuda")
    state = list(init_fn(torch.Generator(device="cuda").manual_seed(0)))
    shape = TOKENS[model]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=shape), device="cuda")

    def one_step():
        state[0], state[1], metrics = step(state[0], state[1], tokens)
        return metrics

    op_group = (moe_matmul_group(cfg, cfg.moe_group_size)
                if cfg.num_experts else None)
    return one_step, shape[0] * (shape[1] - 1), "tokens", op_group


def _vit_step():
    import torch

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.models.training import make_optimizer, tree_leaves

    cfg = vision.ViTConfig.base()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = vision.init_params(cfg, gen, device="cuda")
    opt = make_optimizer()
    state = opt.init(params)
    images = torch.randn((VIT_IMAGES, cfg.image_size, cfg.image_size,
                          cfg.channels), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (VIT_IMAGES,), device="cuda",
                           generator=gen)

    def one_step():
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = vision.loss_fn(params, images, labels, cfg)
        opt.update(params, torch.autograd.grad(loss, leaves), state)
        return loss

    return one_step, VIT_IMAGES, "images", None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=MODELS, default="b1")
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_training: no CUDA device visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import attention

    one_step, per_step, unit, op_group = (
        _vit_step() if args.model == "vit" else _text_step(args.model))
    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = (attention.launches, attention.dq_launches,
              attention.dkdv_launches)
    for count in counts:
        count.reset()
    result = device_profile(one_step, args.steps, op_group)
    calls = 2 * args.steps  # timed steps, then profiled steps
    print(json.dumps({
        "card": card_line(), "model": args.model, unit: per_step,
        f"{unit}_per_s": per_step / (result["ms_cuda_events"] / 1e3),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": {
            name: count.count / calls
            for name, count in zip(("fwd", "dq", "dkdv"), counts)},
        **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
