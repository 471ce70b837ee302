"""Time this tree's flash-attention kernels against another checkout's, in
one process on one card, alternated.

    python3 -m ray_tpu_torch.tools.compare_kernels --baseline DIR [--rounds N]
        [--shapes NAME,NAME,...]

DIR is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a git-ignored directory). Both
trees' ``ray_tpu_torch/ops/attention.py`` are loaded side by side as
standalone modules; each builds its own kernels from its own sources into
its own ``_build`` directory. At each of ``SHAPES`` (b1's served forward
and train step, bench.py's xl head dim 160 at B2 and at its train step's
B8, and chip_smoke.py's d 256, d 80 and d 192 rows, for K1 and for K2
and K3, in bf16; K1 past 256 at chip_smoke.py's rows, in bf16 and fp32,
each row's dtype given with it; K1 on its cp.async-fed wgmma kernels and
at d 16 at chip_smoke.py's d16_bf16, d20_ragged, d33_odd, d100_wide,
d300, d300_wide and d301 rows; K2 and K3 past 256 at chip_smoke.py's
d264, d320, d512, d512_wide, b1_h4_train, d320_f32 and d320_f32_wide
rows, and where they left mma.sync at its d16_bf16, d20_ragged, d33_odd,
d100_wide, d300, d300_wide and d301 rows; all three at its entry_train
row, and in fp32 up to 256 (K1 and K3 on their ring kernels, K2 on FMA)
at its debug_f32, ragged, d16_f32_wide and d128_f32_wide rows) the
script checks that
the two trees' outputs agree, then times the forward (K1), the dq
backward (K2) or the dk/dv backward (K3) with CUDA events in the order
baseline, current, current, baseline, repeated ``--rounds`` times, and
beside them one PyTorch library call on the same inputs as a yardstick
(scaled_dot_product_attention's forward for K1, its whole backward for K2
and K3), and prints one JSON line with every timing, the mean of each,
the factor baseline/current, the library's time, and the card's name and
power limit. CUDA events around back-to-back calls time the host's
launch path too, which sets the time at the small rows; so each row also
gets the device time of one call of each (``device_ms``: the kernels'
durations in a torch.profiler trace of ITERS calls, summed, over ITERS).
Needs CUDA (exits 2 without it).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

from ray_tpu_torch.tools.profile_serving import card_line

SHAPES = [
    # name, kernel, B, Sq, Sk, H, D, causal, dtype — b1's served forward,
    # its train step's forward, dq and dk/dv backward; K1, K2 and K3 at
    # bench.py's xl head dim 160 (B2, and B8: the xl16 train step), and at
    # chip_smoke.py's d256_ragged, d80_sq_lt_sk and d192_noncausal rows;
    # K1 past 256 at chip_smoke.py's rows: d264, d320, d512 and d512_wide
    # in bf16, d320_f32 and d320_f32_wide in fp32; K1 where it left
    # mma.sync: d 16 (fed by TMA), 20 and 100 (cp.async), 33 (through
    # registers), past 256 d 300 (cp.async) and 301 (through registers)
    # at chip_smoke.py's rows; K2 and K3 past 256 at chip_smoke.py's rows
    # (d264, d320, d512, d512_wide and b1_h4_train in bf16, d320_f32 and
    # d320_f32_wide in fp32); K2 and K3 where they left mma.sync: d 16
    # (fed by TMA), 20 and 100 (cp.async), 33 (through registers), past
    # 256 d 300 (cp.async, at both sizes) and 301 (through registers); all
    # three at the entry_train step's attention (d 32, fed by TMA); fp32
    # up to 256 (K1 and K3 on their ring kernels, K2 on FMA) at
    # ModelConfig.debug's d 16, chip_smoke.py's ragged rows (d 64, K2 and
    # K3 at Sk 700) and at d 16 and 128 at B2 S2048 H16, where the
    # arithmetic bounds the work
    ("served_fwd", "fwd", 2, 2048, 2048, 16, 128, True, "bfloat16"),
    ("train_fwd", "fwd", 8, 2048, 2048, 16, 128, True, "bfloat16"),
    ("d160_fwd", "fwd", 2, 2048, 2048, 16, 160, True, "bfloat16"),
    ("xl16_fwd", "fwd", 8, 2048, 2048, 16, 160, True, "bfloat16"),
    ("d256_fwd", "fwd", 1, 1000, 1000, 4, 256, True, "bfloat16"),
    ("d80_fwd", "fwd", 1, 700, 1000, 4, 80, True, "bfloat16"),
    ("d192_fwd", "fwd", 2, 1000, 1000, 8, 192, False, "bfloat16"),
    ("d264_fwd", "fwd", 1, 1000, 1000, 4, 264, True, "bfloat16"),
    ("d320_fwd", "fwd", 1, 1000, 1000, 4, 320, True, "bfloat16"),
    ("d512_fwd", "fwd", 1, 1000, 1000, 4, 512, True, "bfloat16"),
    ("d512_wide_fwd", "fwd", 2, 2048, 2048, 8, 512, True, "bfloat16"),
    ("d320_f32_fwd", "fwd", 1, 1000, 1000, 4, 320, True, "float32"),
    ("d320_f32_wide_fwd", "fwd", 2, 2048, 2048, 8, 320, True, "float32"),
    ("d16_bf16_fwd", "fwd", 2, 1000, 1000, 4, 16, True, "bfloat16"),
    ("d20_ragged_fwd", "fwd", 1, 1000, 700, 4, 20, False, "bfloat16"),
    ("d100_wide_fwd", "fwd", 2, 2048, 2048, 16, 100, True, "bfloat16"),
    ("d300_fwd", "fwd", 1, 1000, 1000, 4, 300, True, "bfloat16"),
    ("d300_wide_fwd", "fwd", 2, 2048, 2048, 8, 300, True, "bfloat16"),
    ("d33_odd_fwd", "fwd", 1, 1000, 1000, 4, 33, True, "bfloat16"),
    ("d301_fwd", "fwd", 1, 1000, 1000, 4, 301, True, "bfloat16"),
    ("train_dq", "dq", 8, 2048, 2048, 16, 128, True, "bfloat16"),
    ("train_dkdv", "dkdv", 8, 2048, 2048, 16, 128, True, "bfloat16"),
    ("d160_dq", "dq", 2, 2048, 2048, 16, 160, True, "bfloat16"),
    ("d160_dkdv", "dkdv", 2, 2048, 2048, 16, 160, True, "bfloat16"),
    ("xl16_dq", "dq", 8, 2048, 2048, 16, 160, True, "bfloat16"),
    ("xl16_dkdv", "dkdv", 8, 2048, 2048, 16, 160, True, "bfloat16"),
    ("d256_dq", "dq", 1, 1000, 1000, 4, 256, True, "bfloat16"),
    ("d256_dkdv", "dkdv", 1, 1000, 1000, 4, 256, True, "bfloat16"),
    ("d80_dq", "dq", 1, 700, 1000, 4, 80, True, "bfloat16"),
    ("d80_dkdv", "dkdv", 1, 700, 1000, 4, 80, True, "bfloat16"),
    ("d192_dq", "dq", 2, 1000, 1000, 8, 192, False, "bfloat16"),
    ("d192_dkdv", "dkdv", 2, 1000, 1000, 8, 192, False, "bfloat16"),
    ("d264_dq", "dq", 1, 1000, 1000, 4, 264, True, "bfloat16"),
    ("d264_dkdv", "dkdv", 1, 1000, 1000, 4, 264, True, "bfloat16"),
    ("d320_dq", "dq", 1, 1000, 1000, 4, 320, True, "bfloat16"),
    ("d320_dkdv", "dkdv", 1, 1000, 1000, 4, 320, True, "bfloat16"),
    ("d512_dq", "dq", 1, 1000, 1000, 4, 512, True, "bfloat16"),
    ("d512_dkdv", "dkdv", 1, 1000, 1000, 4, 512, True, "bfloat16"),
    ("d512_wide_dq", "dq", 2, 2048, 2048, 8, 512, True, "bfloat16"),
    ("d512_wide_dkdv", "dkdv", 2, 2048, 2048, 8, 512, True, "bfloat16"),
    ("b1_h4_train_dq", "dq", 8, 2048, 2048, 4, 512, True, "bfloat16"),
    ("b1_h4_train_dkdv", "dkdv", 8, 2048, 2048, 4, 512, True, "bfloat16"),
    ("d320_f32_dq", "dq", 1, 1000, 1000, 4, 320, True, "float32"),
    ("d320_f32_dkdv", "dkdv", 1, 1000, 1000, 4, 320, True, "float32"),
    ("d320_f32_wide_dq", "dq", 2, 2048, 2048, 8, 320, True, "float32"),
    ("d320_f32_wide_dkdv", "dkdv", 2, 2048, 2048, 8, 320, True, "float32"),
    ("d16_bf16_dq", "dq", 2, 1000, 1000, 4, 16, True, "bfloat16"),
    ("d16_bf16_dkdv", "dkdv", 2, 1000, 1000, 4, 16, True, "bfloat16"),
    ("d20_ragged_dq", "dq", 1, 1000, 700, 4, 20, False, "bfloat16"),
    ("d20_ragged_dkdv", "dkdv", 1, 1000, 700, 4, 20, False, "bfloat16"),
    ("d33_odd_dq", "dq", 1, 1000, 1000, 4, 33, True, "bfloat16"),
    ("d33_odd_dkdv", "dkdv", 1, 1000, 1000, 4, 33, True, "bfloat16"),
    ("d100_wide_dq", "dq", 2, 2048, 2048, 16, 100, True, "bfloat16"),
    ("d100_wide_dkdv", "dkdv", 2, 2048, 2048, 16, 100, True, "bfloat16"),
    ("d300_dq", "dq", 1, 1000, 1000, 4, 300, True, "bfloat16"),
    ("d300_dkdv", "dkdv", 1, 1000, 1000, 4, 300, True, "bfloat16"),
    ("d300_wide_dq", "dq", 2, 2048, 2048, 8, 300, True, "bfloat16"),
    ("d300_wide_dkdv", "dkdv", 2, 2048, 2048, 8, 300, True, "bfloat16"),
    ("d301_dq", "dq", 1, 1000, 1000, 4, 301, True, "bfloat16"),
    ("d301_dkdv", "dkdv", 1, 1000, 1000, 4, 301, True, "bfloat16"),
    ("entry_train_fwd", "fwd", 16, 512, 512, 8, 32, True, "bfloat16"),
    ("entry_train_dq", "dq", 16, 512, 512, 8, 32, True, "bfloat16"),
    ("entry_train_dkdv", "dkdv", 16, 512, 512, 8, 32, True, "bfloat16"),
    ("debug_f32_fwd", "fwd", 2, 128, 128, 4, 16, True, "float32"),
    ("debug_f32_dq", "dq", 2, 128, 128, 4, 16, True, "float32"),
    ("debug_f32_dkdv", "dkdv", 2, 128, 128, 4, 16, True, "float32"),
    ("ragged_f32_fwd", "fwd", 1, 1000, 1000, 4, 64, False, "float32"),
    ("ragged_f32_dq", "dq", 1, 1000, 700, 4, 64, False, "float32"),
    ("ragged_f32_dkdv", "dkdv", 1, 1000, 700, 4, 64, False, "float32"),
    ("d16_f32_wide_fwd", "fwd", 2, 2048, 2048, 16, 16, True, "float32"),
    ("d16_f32_wide_dq", "dq", 2, 2048, 2048, 16, 16, True, "float32"),
    ("d16_f32_wide_dkdv", "dkdv", 2, 2048, 2048, 16, 16, True, "float32"),
    ("d128_f32_wide_fwd", "fwd", 2, 2048, 2048, 16, 128, True, "float32"),
    ("d128_f32_wide_dq", "dq", 2, 2048, 2048, 16, 128, True, "float32"),
    ("d128_f32_wide_dkdv", "dkdv", 2, 2048, 2048, 16, 128, True,
     "float32"),
]
ITERS = 20
# the two trees round p (and ds) to bf16 in the same places but sum in
# other orders: a few bf16 steps of values up to ~6 (as chip_smoke's
# KERNEL_TOL / BWD_TOL); in fp32 summation order only (KERNEL_TOL's 1e-4)
AGREE_ATOL = {"bfloat16": 5e-2, "float32": 1e-4}


def load_attention(root: Path, name: str):
    path = root / "ray_tpu_torch" / "ops" / "attention.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.build_kernels()
    return module


def _inputs(b, sq, sk, h, d, dtype):
    import torch

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(sq + d)
    q, do = (torch.randn((b, sq, h, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((b, sk, h, d), generator=g, device="cuda").to(dt)
            for _ in range(2))
    return q, k, v, do


def _call(mod, kernel, q, k, v, do, causal):
    """A closure launching ``kernel`` of module ``mod`` once; it returns
    the kernel's outputs as a tuple."""
    import torch

    scale = q.shape[-1] ** -0.5
    if kernel == "fwd":
        return lambda: mod._fwd_dispatch(q, k, v, causal)
    out, lse = mod._fwd_dispatch(q, k, v, causal)
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(),
                         do.float()).contiguous()
    if kernel == "dq":
        return lambda: (mod._kernel_bwd_dq(q, k, v, do, lse, delta, causal,
                                           scale),)
    return lambda: mod._kernel_bwd_dkdv(q, k, v, do, lse, delta, causal,
                                        scale)


def _library(kernel, q, k, v, do, causal):
    """A closure of the PyTorch call computing the same function on the
    same inputs: SDPA's forward for K1, SDPA's backward (dq, dk and dv in
    one call) for K2 and K3."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    if kernel == "fwd":
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def _ms(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _device_ms(fn) -> float:
    """The device time of one call of ``fn``: every kernel it launches,
    by a torch.profiler trace (CUPTI) of ITERS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / ITERS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", required=True, type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--shapes", default="",
                        help="comma-separated SHAPES names (default: all)")
    args = parser.parse_args(argv)
    wanted = set(filter(None, args.shapes.split(",")))
    unknown = wanted - {row[0] for row in SHAPES}
    if unknown:
        parser.error(f"unknown shapes {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device visible", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[2]
    mods = {"baseline": load_attention(args.baseline.resolve(),
                                       "attention_baseline"),
            "current": load_attention(here, "attention_current")}
    rows = []
    for name, kernel, b, sq, sk, h, d, causal, dtype in SHAPES:
        if wanted and name not in wanted:
            continue
        q, k, v, do = _inputs(b, sq, sk, h, d, dtype)
        calls = {tag: _call(mod, kernel, q, k, v, do, causal)
                 for tag, mod in mods.items()}
        outs = {tag: fn() for tag, fn in calls.items()}
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(outs["baseline"], outs["current"]))
        if not err <= AGREE_ATOL[dtype]:
            raise AssertionError(f"{name}: the two trees disagree, max abs "
                                 f"{err} > {AGREE_ATOL[dtype]}")
        times = {"baseline": [], "current": []}
        for _ in range(args.rounds):
            for tag in ("baseline", "current", "current", "baseline"):
                times[tag].append(_ms(calls[tag]))
        mean = {tag: sum(x) / len(x) for tag, x in times.items()}
        library = _library(kernel, q, k, v, do, causal)
        library_ms = _ms(library)
        device_ms = {tag: _device_ms(fn) for tag, fn in
                     (*calls.items(), ("library", library))}
        routes = {tag: mod.kernel_route(kernel, q.dtype, d)
                  for tag, mod in mods.items()}
        rows.append({"shape": name, "kernel": kernel, "B": b, "Sq": sq,
                     "Sk": sk, "H": h, "D": d, "causal": causal,
                     "dtype": dtype, "routes": routes,
                     "max_abs_diff": err, "ms": times,
                     "mean_ms": mean,
                     "baseline_over_current": mean["baseline"]
                     / mean["current"],
                     "library_ms": library_ms, "device_ms": device_ms})
        print(f"{name} ({dtype}; {routes['baseline']} -> "
              f"{routes['current']}): baseline {mean['baseline']:.4f} ms, "
              f"current {mean['current']:.4f} ms, "
              f"x{rows[-1]['baseline_over_current']:.3f} (max abs diff "
              f"{err:.3g}); library {library_ms:.4f} ms; device ms "
              + ", ".join(f"{t} {x:.4f}" for t, x in device_ms.items()),
              flush=True)
        del q, k, v, do, outs, calls
    print(json.dumps({"card": card_line(), "baseline": str(args.baseline),
                      "order": "baseline, current, current, baseline",
                      "iters": ITERS, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
