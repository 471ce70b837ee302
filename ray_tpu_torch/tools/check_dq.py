"""The short first check of the dq backward kernel (K2) of one checkout.

    python3 -m ray_tpu_torch.tools.check_dq [TREE]

TREE is a checkout of this repository (default: this one); its
``ray_tpu_torch/ops/attention.py`` is loaded as a standalone module and
builds its own kernels, as ``compare_kernels`` does. The script prints
the card's name and power limit, ptxas's report for each instantiation
of ``bwd_dq_ws_kernel``, then runs K2 once at each shape below, from
b1's train step down to a single query row, and holds it against
``_blockwise_bwd``'s dq within ``BWD_TOL`` (chip_smoke.py's bf16
tolerance). At the two full-size shapes it also times 20 launches with
CUDA events. Exits 1 if any shape disagrees, 2 without CUDA.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from ray_tpu_torch.tools.compare_kernels import load_attention
from ray_tpu_torch.tools.profile_serving import card_line

SHAPES = [
    # name, B, Sq, Sk, H, D, causal, timed — b1's train step; the ragged
    # backward rows of chip_smoke.py; one q tile whose lower warpgroup
    # lies past Sq; one query row; Sq > Sk with a q tile past every key;
    # few queries over many keys without the causal bound; head_dim 64
    ("train", 8, 2048, 2048, 16, 128, True, True),
    ("ragged_bf16", 1, 1000, 700, 4, 64, True, False),
    ("sq_lt_sk_bf16", 1, 700, 1000, 4, 128, True, False),
    ("ragged_noncausal_bf16", 1, 1000, 1000, 4, 128, False, False),
    ("tiny_causal", 1, 64, 64, 2, 128, True, False),
    ("sq1", 2, 1, 300, 2, 64, True, False),
    ("sq130_sk50", 1, 130, 50, 2, 128, True, False),
    ("sq100_sk1000_nc", 1, 100, 1000, 2, 64, False, False),
    ("d64_full", 2, 2048, 2048, 16, 64, True, True),
]
BWD_TOL = (5e-2, 2e-2)  # (atol, rtol), as chip_smoke.py's bf16 BWD_TOL
ITERS = 20


def ptxas_rows(log: str, kernel: str) -> list:
    """The lines of ``nvcc -Xptxas=-v``'s report for each function whose
    mangled name contains ``kernel``."""
    rows, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep:
            rows.append(line.strip())
    return rows


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("check_dq: no CUDA device visible", file=sys.stderr)
        return 2
    root = Path(argv[0] if argv else Path(__file__).parents[2]).resolve()
    t0 = time.monotonic()
    mod = load_attention(root, "attention_checked")
    print(f"tree {root}: built in {time.monotonic() - t0:.1f} s on "
          f"{card_line()}", flush=True)
    for line in ptxas_rows(mod.build_kernels(), "bwd_dq_ws_kernel"):
        print("ptxas", line, flush=True)
    ok = True
    for name, b, sq, sk, h, d, causal, timed in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
        q, do = (torch.randn((b, sq, h, d), generator=g, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn((b, sk, h, d), generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        scale = d ** -0.5
        out, lse = mod._fwd_dispatch(q, k, v, causal)
        delta = torch.einsum("bqhd,bqhd->bhq", out.float(),
                             do.float()).contiguous()

        def run():
            return mod._kernel_bwd_dq(q, k, v, do, lse, delta, causal, scale)

        dq = run()
        torch.cuda.synchronize()
        want = mod._blockwise_bwd(q, k, v, out, lse, do, causal, scale)[0]
        err = (dq.float() - want.float()).abs().max().item()
        good = bool(torch.isfinite(dq).all()) and torch.allclose(
            dq.float(), want.float(), atol=BWD_TOL[0], rtol=BWD_TOL[1])
        ok &= good
        msg = ""
        if timed:
            for _ in range(3):
                run()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(ITERS):
                run()
            end.record()
            torch.cuda.synchronize()
            msg = f" {start.elapsed_time(end) / ITERS:.4f} ms"
        print(f"{name}: route {mod.kernel_route('dq', q.dtype, d)} max abs "
              f"err {err:.4g} {'ok' if good else 'BAD'}{msg}", flush=True)
    print("ALL OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
