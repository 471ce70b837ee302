"""Where one served forward spends its device time.

    python3 -m ray_tpu_torch.tools.profile_serving [--model b1|moe|vit]
        [--requests N]

Builds the model on the card (random weights, seed 0): ``ModelConfig.b1``
or the bench's MoE model (``ModelConfig.moe_bench``) on [2, 2048] tokens,
or ViT-B/16 (``ViTConfig.base``) on 64 images of 224 px. Warms the
forward up, times N forwards with CUDA events, then runs N more under
``torch.profiler`` (CPU + CUDA activity, with input shapes) and prints one
JSON line: device time per forward by kernel group (the flash-attention
kernels, matrix products, everything else), for the MoE model the matrix
products split by the op that ran them (dispatch/combine einsums, expert
GEMMs), the busiest kernels, and the device's idle share of the profiled
window (``device_profile``, shared with ``profile_training``). Needs CUDA
(exits 2 without it) and fails if the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

MODELS = ("b1", "moe", "vit")
_MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


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


def moe_matmul_group(cfg, tokens_per_group: int):
    """A classifier of matmul ops by their input shapes for a MoE model:
    ``(op name, input shapes) -> "moe_dispatch_combine" | "moe_experts" |
    None``. The dispatch and combine products carry the E*C dimension
    (or are the [g, k, *] one-hot products, batched over the group's
    tokens); the experts' GEMMs are batched over E."""
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * tokens_per_group * k / e))

    def classify(name, shapes):
        if name not in _MATMUL_OPS:
            return None
        shapes = [list(s) for s in shapes if s]
        if any(e * cap in s for s in shapes) or (
                name.endswith("bmm") and shapes
                and shapes[0][0] == tokens_per_group):
            return "moe_dispatch_combine"
        if name.endswith("bmm") and shapes and shapes[0][0] == e:
            return "moe_experts"
        return None

    return classify


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_profile(fn, n: int, op_group=None) -> dict:
    """``fn`` (already warm) timed n times with CUDA events, then run n
    more times under torch.profiler (CPU + CUDA activity, input shapes
    recorded): per call, the CUDA-event time, the profiled window, device
    time by kernel group and the busiest kernels, and the device's idle
    share of the window. With ``op_group(op name, input shapes) -> group
    or None``, the device time of the kernels each matching op launched
    is also summed by group (``op_group_ms``). Raises if the profiler
    records no device time. ``device_idle_share_events`` compares the
    profiled device time with the unprofiled CUDA-event time instead."""
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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=op_group is not None) as prof:
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
    out = {
        "calls": n, "ms_cuda_events": event_ms,
        "profiled_window_ms": window_ms / n,
        "device_ms": device_ms / n,
        "device_idle_share": max(0.0, 1.0 - device_ms / window_ms),
        # the profiler's own host cost (record_shapes most of all) widens
        # its window; the unprofiled CUDA-event time bounds the idle share
        # from the other side
        "device_idle_share_events": max(
            0.0, 1.0 - device_ms / n / event_ms),
        "group_ms": {g: ms / n for g, ms in groups.items()},
        "top_kernels_ms": [[k[:120], ms / n] for k, ms in top],
    }
    if op_group is not None:
        by_op = {}
        for evt in prof.key_averages(group_by_input_shape=True):
            if evt.device_type != DeviceType.CPU:
                continue
            g = op_group(evt.key, evt.input_shapes)
            if g is not None and evt.self_device_time_total > 0:
                by_op[g] = by_op.get(g, 0.0) + evt.self_device_time_total
        out["op_group_ms"] = {g: us / 1e3 / n for g, us in by_op.items()}
    return out


def build_model(model: str, device: str = "cuda"):
    """(cfg, params, inputs, op_group) for a served forward of ``model``:
    b1 and moe on [2, 2048] tokens, vit on 64 images."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    if model == "vit":
        from ray_tpu_torch.models import vision

        cfg = vision.ViTConfig.base()
        params = vision.init_params(cfg, gen, device=device)
        images = torch.randn((64, cfg.image_size, cfg.image_size,
                              cfg.channels), generator=gen, device=device)
        return cfg, params, images, None
    from ray_tpu_torch.models import transformer as tfm

    cfg = (tfm.ModelConfig.b1() if model == "b1"
           else tfm.ModelConfig.moe_bench())
    params = tfm.init_params(cfg, gen, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), device=device,
                           generator=gen)
    op_group = (moe_matmul_group(cfg, min(cfg.moe_group_size, 2 * 2048))
                if cfg.num_experts else None)
    return cfg, params, tokens, op_group


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=MODELS, default="b1")
    parser.add_argument("--requests", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import vision
    from ray_tpu_torch.models.training import build_forward
    from ray_tpu_torch.ops import attention

    cfg, params, inputs, op_group = build_model(args.model)
    if args.model == "vit":
        def fwd():
            with torch.no_grad():
                return vision.forward(params, inputs, cfg)
    else:
        forward = build_forward(cfg, device="cuda")

        def fwd():
            return forward(params, inputs)
    for _ in range(3):
        fwd()
    torch.cuda.synchronize()
    attention.launches.reset()
    result = device_profile(fwd, args.requests, op_group)
    print(json.dumps({
        "card": card_line(), "model": args.model,
        "inputs": list(inputs.shape),
        "attention_launches": attention.launches.count, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
