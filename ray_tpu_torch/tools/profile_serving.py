"""Where one served ModelConfig.b1 forward spends its device time.

    python3 -m ray_tpu_torch.tools.profile_serving [--requests N]

Builds ``ModelConfig.b1`` on the card (random weights, seed 0), warms the
forward up on [2, 2048] tokens, times N forwards with CUDA events, then
runs N more under ``torch.profiler`` (CPU + CUDA activity) and prints one
JSON line: device time per forward by kernel group (the flash-attention
kernels, matrix products, everything else), the busiest kernels, and the
device's idle share of the profiled window (``device_profile``, shared
with ``profile_training``). Needs CUDA (exits 2 without it) and fails if
the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "attention_fwd_kernel"
    if "bwd_dq" in low:
        return "attention_bwd_dq_kernel"
    if "bwd_dkdv" in low:
        return "attention_bwd_dkdv_kernel"
    if any(tag in low for tag in ("gemm", "cutlass", "xmma", "nvjet",
                                  "cublas", "matmul")):
        return "matmul"
    return "other"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_profile(fn, n: int) -> dict:
    """``fn`` (already warm) timed n times with CUDA events, then run n
    more times under torch.profiler (CPU + CUDA activity): per call, the
    CUDA-event time, the profiled window, device time by kernel group and
    the busiest kernels, and the device's idle share of the window.
    Raises if the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / n

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
    device_ms = sum(kernels.values())
    if device_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    groups = {}
    for name, ms in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {
        "calls": n, "ms_cuda_events": event_ms,
        "profiled_window_ms": window_ms / n,
        "device_ms": device_ms / n,
        "device_idle_share": max(0.0, 1.0 - device_ms / window_ms),
        "group_ms": {g: ms / n for g, ms in groups.items()},
        "top_kernels_ms": [[k[:120], ms / n] for k, ms in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--requests", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_forward
    from ray_tpu_torch.ops import attention

    cfg = tfm.ModelConfig.b1()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tfm.init_params(cfg, gen, device="cuda")
    fwd = build_forward(cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), device="cuda",
                           generator=gen)
    for _ in range(3):
        fwd(params, tokens)
    torch.cuda.synchronize()
    attention.launches.reset()
    result = device_profile(lambda: fwd(params, tokens), args.requests)
    print(json.dumps({
        "card": card_line(), "model": "ModelConfig.b1", "tokens": [2, 2048],
        "attention_launches": attention.launches.count, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
