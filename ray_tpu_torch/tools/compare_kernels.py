"""Time this tree's flash-attention kernels against another checkout's, in
one process on one card, alternated.

    python3 -m ray_tpu_torch.tools.compare_kernels --baseline DIR [--rounds N]

DIR is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a git-ignored directory). Both
trees' ``ray_tpu_torch/ops/attention.py`` are loaded side by side as
standalone modules; each builds its own kernels from its own sources into
its own ``_build`` directory. At the b1 shapes (the served forward B2 and
the train step B8, S2048 H16 D128 causal bf16) the script checks that the
two trees' outputs agree, then times the forward (K1), the dq backward
(K2) and the dk/dv backward (K3) with CUDA events in the order baseline,
current, current, baseline, repeated ``--rounds`` times, and prints one
JSON line with every timing, the mean of each, the factor
baseline/current, and the card's name and power limit. Needs CUDA (exits
2 without it).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

from ray_tpu_torch.tools.profile_serving import card_line

SHAPES = [
    # name, kernel, B, S, H, D — b1's served forward, its train step's
    # forward, dq and dk/dv backward (causal, bf16)
    ("served_fwd", "fwd", 2, 2048, 16, 128),
    ("train_fwd", "fwd", 8, 2048, 16, 128),
    ("train_dq", "dq", 8, 2048, 16, 128),
    ("train_dkdv", "dkdv", 8, 2048, 16, 128),
]
ITERS = 20
# the two trees round p (and ds) to bf16 in the same places but sum in
# other orders: a few bf16 steps of values up to ~6 (as chip_smoke's
# KERNEL_TOL / BWD_TOL)
AGREE_ATOL = 5e-2


def load_attention(root: Path, name: str):
    path = root / "ray_tpu_torch" / "ops" / "attention.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.build_kernels()
    return module


def _inputs(b, s, h, d):
    import torch

    g = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    return q, k, v, do


def _call(mod, kernel, q, k, v, do):
    """A closure launching ``kernel`` of module ``mod`` once; it returns
    the kernel's outputs as a tuple."""
    import torch

    scale = q.shape[-1] ** -0.5
    if kernel == "fwd":
        return lambda: mod._fwd_dispatch(q, k, v, True)
    out, lse = mod._fwd_dispatch(q, k, v, True)
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(),
                         do.float()).contiguous()
    if kernel == "dq":
        return lambda: (mod._kernel_bwd_dq(q, k, v, do, lse, delta, True,
                                           scale),)
    return lambda: mod._kernel_bwd_dkdv(q, k, v, do, lse, delta, True, scale)


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", required=True, type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device visible", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[2]
    mods = {"baseline": load_attention(args.baseline.resolve(),
                                       "attention_baseline"),
            "current": load_attention(here, "attention_current")}
    rows = []
    for name, kernel, b, s, h, d in SHAPES:
        q, k, v, do = _inputs(b, s, h, d)
        calls = {tag: _call(mod, kernel, q, k, v, do)
                 for tag, mod in mods.items()}
        outs = {tag: fn() for tag, fn in calls.items()}
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(outs["baseline"], outs["current"]))
        if not err <= AGREE_ATOL:
            raise AssertionError(f"{name}: the two trees disagree, max abs "
                                 f"{err} > {AGREE_ATOL}")
        times = {"baseline": [], "current": []}
        for _ in range(args.rounds):
            for tag in ("baseline", "current", "current", "baseline"):
                times[tag].append(_ms(calls[tag]))
        mean = {tag: sum(x) / len(x) for tag, x in times.items()}
        rows.append({"shape": name, "kernel": kernel, "B": b, "S": s,
                     "H": h, "D": d, "max_abs_diff": err, "ms": times,
                     "mean_ms": mean,
                     "baseline_over_current": mean["baseline"]
                     / mean["current"]})
        print(f"{name}: baseline {mean['baseline']:.4f} ms, current "
              f"{mean['current']:.4f} ms, x{rows[-1]['baseline_over_current']:.3f}"
              f" (max abs diff {err:.3g})", flush=True)
        del q, k, v, do, outs, calls
    print(json.dumps({"card": card_line(), "baseline": str(args.baseline),
                      "order": "baseline, current, current, baseline",
                      "iters": ITERS, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
