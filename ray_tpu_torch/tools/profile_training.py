"""Where one ModelConfig.b1 train step spends its device time.

    python3 -m ray_tpu_torch.tools.profile_training [--steps N]

Builds ``ModelConfig.b1`` on the card (random weights, seed 0, remat
"full") with ``build_train_step``, takes two warm-up steps on one seeded
[8, 2049] token batch, times N steps with CUDA events, then runs N more
under ``torch.profiler`` and prints one JSON line: device time per step
by kernel group (the flash-attention forward and backward kernels,
matrix products, everything else), the busiest kernels, the device's
idle share of the profiled window, tokens per second and peak device
memory. Needs CUDA (exits 2 without it) and fails if the profiler
records no device time.
"""

from __future__ import annotations

import argparse
import json
import sys

from ray_tpu_torch.tools.profile_serving import card_line, device_profile

TOKENS = (8, 2049)  # [B, S + 1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_training: no CUDA device visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_train_step
    from ray_tpu_torch.ops import attention

    cfg = tfm.ModelConfig.b1()
    step, init_fn = build_train_step(cfg, device="cuda")
    state = list(init_fn(torch.Generator(device="cuda").manual_seed(0)))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=TOKENS), device="cuda")

    def one_step():
        state[0], state[1], metrics = step(state[0], state[1], tokens)
        return metrics

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = (attention.launches, attention.dq_launches,
              attention.dkdv_launches)
    for count in counts:
        count.reset()
    result = device_profile(one_step, args.steps)
    calls = 2 * args.steps  # timed steps, then profiled steps
    tokens_per_step = TOKENS[0] * (TOKENS[1] - 1)
    print(json.dumps({
        "card": card_line(), "model": "ModelConfig.b1 (remat full)",
        "tokens": list(TOKENS),
        "tokens_per_s": tokens_per_step / (result["ms_cuda_events"] / 1e3),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": {
            name: count.count / calls
            for name, count in zip(("fwd", "dq", "dkdv"), counts)},
        **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
