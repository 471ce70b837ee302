#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path once and checks it, phase by phase. Every
phase runs even when an earlier one failed (its traceback is printed);
if any failed, the script exits non-zero and prints no result. Phases:

  1. build  — compile the port's CUDA kernels from ray_tpu_torch/ops/csrc
              and print the card's name and power limit;
  2. kernel — hold the flash-attention forward kernel (K1) and the
              backward kernels (K2 dq, K3 dk/dv) against their plain
              torch versions (``_blockwise_fwd``, ``_blockwise_bwd``) on
              the card at the main paths' shapes and at ragged, Sq != Sk
              and head_dim-64 shapes that reach the edges of the TMA
              tiles of K1, K2 and K3 (all three take the wgmma route in
              bf16 at head_dim 64 and 128), and time each kernel, its
              plain version, its bound and one PyTorch library call (a
              yardstick only);
              each row names the route (``attention.kernel_route``) it
              took; rows at head dims 16, 20 (Sq != Sk), 160 and 256
              hold the mma.sync kernels (bf16) and the FMA kernels
              (ModelConfig.debug's fp32 d 16) the same way;
  2b. debug — the JAX package's test configs on the card through the
              kernels (head_dim 16, float32: the FMA route):
              ModelConfig.debug() and tiny_moe() (routed alike) served
              and one train step of each, ViTConfig.debug() served, each
              against the plain attention within DEBUG_REL_L2_TOL, a
              float32 limit;
  3. sched  — drain 256 nodes x 100k tasks x 32 classes through the live
              raylet tick with the placement solve on CUDA: the
              single-buffered tick must place every task where the numpy
              path does, the pipelined tick must drain with the device
              mirror's drift check on;
  4. serve  — ray_tpu_torch.init(device="cuda") with a few nodes; an
              actor holds ModelConfig.b1 at full width and depth (random
              weights from a seed) and answers forward.remote(tokens)
              requests; the kernel's launch count over those requests
              must be 24 per request, all on the wgmma route, and one
              request's logits must agree with the same model on the
              plain attention;
  4b. proc_serve — the process tier: init(worker_mode="process") on
              CUDA; an actor built in its own OS process (given card 0
              by RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES) serves b1 at full
              width and depth through K1 (wgmma), 24 launches a request
              counted in that process; each reply, the last position's
              [2, 32000] fp32 logits, rides the pool's shm segment and is
              held against the serve phase's; a plain task in a pool
              worker without the override sees no card, and
              build_forward raises there;
  4c. cluster — the multi-process cluster (ray_tpu_torch.cluster):
              the GCS's actor-burst placer (GcsService.
              _batch_assign_actors, state-only) places 16,384 actors in
              32 classes over 256 seeded nodes on CUDA, map equal to its
              numpy route's; a ProcessCluster at its default settings
              (its GCS on CUDA, which takes its context at start and
              alone of the servers maps libcuda.so; the raylets'
              workers given card 0; device threshold 0) takes bursts of
              32 and 16 {"CPU": 0.25} actors through
              actor_create_batch: all ALIVE, no node past its CPUs, the
              GCS's solves on CUDA, every node alive with its longest
              heartbeat gap under the 0.5 s timeout; an actor in a
              worker of the GPU raylet serves b1 (24 K1 launches a
              request on wgmma, counted in its process; last-position
              logits bit-equal to the serve phase's); a 64 MiB array put
              on one node is summed by a task on the other; every
              process the phase started is stopped and its shm segments
              swept;
  5. train  — a Cluster with one GPU node; ray_tpu_torch.train.Trainer
              with one GPU worker runs a train function that builds
              ModelConfig.b1 at full width and depth (random weights from
              a seed, remat "full") and takes 4 optimizer steps on one
              seeded [8, 2049] token batch. Losses must be finite and
              falling, K1 must launch 2 x 24 x 4 times (forward and remat
              recompute) and K2 and K3 24 x 4 times each, all three on
              the wgmma route, and one step's gradients must agree with
              the same step on the plain attention, leaf by leaf;
  6. moe    — the bench's sparse model (bench.py's MoE row: hidden 1024,
              8 layers, 16 heads over 8 kv heads, head_dim 64, inter
              2816, vocab 32000, top-2 of 8 experts on every second
              layer, 4096-token groups, remat, logits_chunk 256, bf16) at
              full width and depth: an actor serves it at [2, 2048]
              tokens (K1 8 launches a request, logits held against the
              plain attention); Trainer(num_workers=1, use_gpu=True)
              takes steps on one seeded [16, 2049] batch (K1 2 x 8, K2
              and K3 8 a step, all on the wgmma route at head_dim 64),
              saves (params, opt_state) with models.checkpoint after step
              2, restores it onto a fresh init (every leaf equal), and
              goes on from the restored state; losses finite and falling,
              the aux loss finite and > 0; one step's gradients held
              against the plain attention;
  7. vit    — ViTConfig.base() (ViT-B/16, bf16): an actor serves seeded
              [64, 224, 224, 3] image batches (K1 12 launches a request at
              S 197, non-causal, logits held against the plain
              attention); then 3 ClippedAdamW steps at batch 128 through
              loss_fn and autograd (K1, K2 and K3 12 a step), and one
              step's gradients held against the plain attention.

The line before the last is the card's name and power limit as
nvidia-smi prints them; above it, one JSON line with the kernel table
(``launches`` summed over the model paths, per path in
``launches_by_path``, per route in ``launches_by_route``; ``kernel_route``
is the route at the b1 train shape; ``head_dims_by_route`` the head dims
the kernel phase ran on each route).
The last line is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Without CUDA the script exits 2 and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

# published peaks of one H100 SXM (NVIDIA data sheet; dense): the bound
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version on the card. bf16 out: both round an fp32
# accumulation to bf16 (8 bits), the kernel also rounds P to bf16 before
# P.V as the TPU kernel does, so they differ by up to a few bf16 ulps of
# values of magnitude ~1; lse is fp32 in both from the same bf16 inputs,
# apart only by summation order and exp/log rounding. fp32: summation
# order only.
KERNEL_TOL = {
    "bfloat16": {"out": (2e-2, 2e-2), "lse": (1e-3, 1e-4)},
    "float32": {"out": (1e-4, 1e-4), "lse": (1e-4, 1e-4)},
}
# K2/K3 vs _blockwise_bwd on the card, (atol, rtol) on dq, dk and dv.
# bf16: the kernels round ds (and p, for dv) to bf16 before the products
# that consume them, as the TPU kernels do, and round the results to
# bf16; the plain version keeps fp32 throughout. They differ by a few
# bf16 steps (2^-8 relative) of gradients up to ~6 in magnitude (first
# chip check: max abs 0.031). fp32: summation order only (<= 1e-6).
BWD_TOL = {"bfloat16": (5e-2, 2e-2), "float32": (1e-5, 1e-5)}
# served logits, kernel vs plain attention, relative L2: the two
# attentions round differently at bf16's 2^-9 relative step, and 24
# residual layers compound that; a wrong kernel (mask, scale, row)
# moves the logits by O(1)
SERVE_REL_L2_TOL = 3e-2

KERNEL_SHAPES = [
    # name, B, S, H, D, causal, dtype — b1's served shape, b1's train
    # shape, entry()'s shape after the GQA repeat, a ragged fp32 one, and
    # for the wgmma route: a ragged length (a last q tile and K/V tile
    # that TMA fills past S with zeros), causal and not, and head_dim 64
    ("b1", 2, 2048, 16, 128, True, "bfloat16"),
    ("train", 8, 2048, 16, 128, True, "bfloat16"),
    ("entry", 2, 128, 8, 32, True, "bfloat16"),
    ("ragged", 1, 1000, 4, 64, False, "float32"),
    ("ragged_causal_bf16", 1, 1000, 4, 128, True, "bfloat16"),
    ("ragged_bf16", 1, 1000, 4, 128, False, "bfloat16"),
    ("d64", 2, 2048, 16, 64, True, "bfloat16"),
    # the MoE train step's shape (16 heads after the GQA repeat) and the
    # ViT-B/16 train step's (196 patches + CLS, non-causal)
    ("moe", 16, 2048, 16, 64, True, "bfloat16"),
    ("vit", 128, 197, 12, 64, False, "bfloat16"),
    # head dims off the wgmma route's 64 and 128 (mma.sync in bf16, FMA
    # in fp32): ModelConfig.debug's attention; d 16 in bf16 at a ragged
    # length; d 20 (a 40-byte row: the element-wise loads) with Sq != Sk,
    # given as an 8th field; bench.py's xl width at 16 heads; the widest
    ("debug_f32", 2, 128, 4, 16, True, "float32"),
    ("d16_bf16", 2, 1000, 4, 16, True, "bfloat16"),
    ("d20_ragged", 1, 1000, 4, 20, False, "bfloat16", 700),
    ("d160", 2, 2048, 16, 160, True, "bfloat16"),
    ("d256_ragged", 1, 1000, 4, 256, True, "bfloat16"),
]

BWD_SHAPES = [
    # name, B, Sq, Sk, H, D, causal, dtype — the b1 train step's shape
    # (8 x 2048 tokens), entry()'s shape, a ragged fp32 one with Sq != Sk,
    # and for the wgmma route of K2 and K3: Sq > Sk at head_dim 64 and
    # Sq < Sk at 128 (causal, top-left aligned: the last key tiles see no
    # query and write zeros), both ragged, and a ragged non-causal one
    # (K2's mask of the keys past Sk without the causal bound)
    ("train", 8, 2048, 2048, 16, 128, True, "bfloat16"),
    ("entry", 2, 128, 128, 8, 32, True, "bfloat16"),
    ("ragged", 1, 1000, 700, 4, 64, False, "float32"),
    ("ragged_bf16", 1, 1000, 700, 4, 64, True, "bfloat16"),
    ("sq_lt_sk_bf16", 1, 700, 1000, 4, 128, True, "bfloat16"),
    ("ragged_noncausal_bf16", 1, 1000, 1000, 4, 128, False, "bfloat16"),
    ("moe", 16, 2048, 2048, 16, 64, True, "bfloat16"),
    ("vit", 128, 197, 197, 12, 64, False, "bfloat16"),
    # the kernel phase's rows at head dims off 64 and 128
    ("debug_f32", 2, 128, 128, 4, 16, True, "float32"),
    ("d16_bf16", 2, 1000, 1000, 4, 16, True, "bfloat16"),
    ("d20_ragged", 1, 1000, 700, 4, 20, False, "bfloat16"),
    ("d160", 2, 2048, 2048, 16, 160, True, "bfloat16"),
    ("d256_ragged", 1, 1000, 1000, 4, 256, True, "bfloat16"),
]
# the rows of KERNEL_SHAPES and BWD_SHAPES off the wgmma route, reported
# beside the model shapes in the kernels line
HEAD_DIM_SHAPES = ("debug_f32", "d16_bf16", "d20_ragged", "d160",
                   "d256_ragged")

SCHED = dict(nodes=256, tasks=100_000, classes=32)
# the cluster phase: the GCS burst placer at the scheduler's verdict
# scale (256 nodes x 32 classes = 8,192 cells, the device threshold's
# default), 3 timed bursts a route; the live cluster's burst of
# {"CPU": 0.25} actors; its cross-node object; each raylet's store
CLUSTER_PLACER = dict(nodes=256, actors=16_384, classes=32, bursts=3)
CLUSTER_BURST = 32
CROSS_NODE_BYTES = 64 << 20
CLUSTER_STORE_BYTES = 512 << 20
SERVE_REQUESTS = 4
SERVE_TOKENS = (2, 2048)
TRAIN_STEPS = 4
TRAIN_TOKENS = (8, 2049)  # [B, S + 1]: next-token targets for S = 2048
# the bench's MoE batch (RAY_TPU_BENCH_MODEL_MOE_BATCH's default, 16)
MOE_TRAIN_TOKENS = (16, 2049)
MOE_TRAIN_STEPS = 4
MOE_CKPT_STEP = 2  # saved after 2 steps, restored, and trained on from
# the checkpoint of the moe phase: in the checkout (listed in .gitignore)
# and removed when the phase ends
CKPT_DIR = ".chip_smoke_ckpt"
VIT_SERVE_IMAGES = 64
VIT_TRAIN_IMAGES = 128
VIT_TRAIN_STEPS = 3
# one step's gradients, kernels vs the plain attention, relative L2 per
# leaf: both run the same bf16 model; the kernels round p and ds to bf16
# inside attention (the plain version keeps fp32) and that difference
# flows back through 24 layers; a wrong kernel (mask, scale, transpose)
# moves the gradients by O(1)
GRAD_REL_L2_TOL = 5e-2
# the debug phase's float32 configs, kernels vs plain attention, relative
# L2 on the logits and on the worst gradient leaf: fp32 in and fp32
# accumulate on both sides, apart only by summation order (~1e-6). A
# bf16 (2^-9) or TF32 (2^-11) product inside a kernel would move them by
# ~1e-3, so the b1 limits above, set for bf16, would not see it
DEBUG_REL_L2_TOL = 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 1


def ptxas_report(log: str) -> list:
    """One row per compiled kernel of ``nvcc -Xptxas=-v``'s report: its
    name, registers, spill bytes and any performance note."""
    rows, notes = [], {}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            rows.append({"kernel": ln.split("'")[1], "notes": []})
        elif "Potential Performance Loss" in ln:
            # names its function, and may come before that function's rows
            notes.setdefault(ln.split("'")[1], []).append(
                ln.split("Loss:")[1].split(" for ")[0].strip())
        elif rows and "spill stores" in ln:
            rows[-1]["spill"] = ln.split(":")[-1].strip()
        elif rows and "Used" in ln and "registers" in ln:
            rows[-1]["registers"] = int(ln.split("Used")[1].split()[0])
    for row in rows:
        row["notes"] = notes.get(row["kernel"], [])
    return rows


def _spill_bytes(spill: str) -> int:
    """The spill-store bytes of a ptxas "... bytes spill stores ..." line."""
    found = re.search(r"(\d+) bytes spill stores", spill)
    return int(found.group(1)) if found else 0


def phase_build(report: dict) -> None:
    from ray_tpu_torch.ops import attention

    t0 = time.monotonic()
    log = attention.build_kernels()
    report["build_s"] = time.monotonic() - t0
    report["ptxas"] = ptxas_report(log)
    report["card"] = card_line()
    print(f"build: kernels built in {report['build_s']:.1f} s on "
          f"{report['card']}", flush=True)
    for row in report["ptxas"]:
        if "_ws_kernel" in row["kernel"]:
            print(f"build: ptxas {row['kernel'][-60:]}: "
                  f"{row.get('registers')} registers at entry, "
                  f"{row.get('spill')} {row['notes']}", flush=True)
    # the mma.sync and FMA kernels: one instantiation per padded head dim
    small = [r for r in report["ptxas"]
             if "mma_kernel" in r["kernel"] or "f32_kernel" in r["kernel"]]
    spilling = [r for r in small if _spill_bytes(r.get("spill", ""))]
    report["ptxas_mma_fma"] = {
        "kernels": len(small),
        "max_registers": max((r.get("registers", 0) for r in small),
                             default=0),
        "spilling": [f"{r['kernel']}: {r.get('spill')}" for r in spilling]}
    print(f"build: {len(small)} mma.sync and FMA instantiations, at most "
          f"{report['ptxas_mma_fma']['max_registers']} registers, "
          f"{len(spilling)} of them spill", flush=True)


# --------------------------------------------------------------- phase 2


def _pairs(sq, sk, causal):
    """(query, key) pairs the mask keeps (top-left causal alignment)."""
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


def _attention_work(kernel, b, sq, sk, h, d, causal, dtype):
    """(bound ms, what bounds it): the larger of FLOPs over the card's
    peak and bytes over its HBM rate. FLOPs: 2*d per kept pair and
    product (fwd: S, P.V; dq: S, dP, ds.K; dk/dv: S, dP, p.dO, ds.Q).
    Bytes: each input read once, each output written once."""
    elt = 2 if dtype == "bfloat16" else 4
    q_bytes = b * sq * h * d * elt
    kv_bytes = b * sk * h * d * elt
    row_bytes = b * h * sq * 4  # lse or delta
    products, nbytes = {
        "fwd": (2, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "dq": (3, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        "dkdv": (4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }[kernel]
    flops = 2 * d * products * b * h * _pairs(sq, sk, causal)
    t_ops = flops / H100_PEAK_FLOPS[dtype]
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernel(report: dict) -> None:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    rows = []
    for name, b, s, h, d, causal, dtype, *rest in KERNEL_SHAPES:
        sk = rest[0] if rest else s
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(len(rows))
        q = torch.randn((b, s, h, d), generator=g, device="cuda").to(dt)
        k, v = (torch.randn((b, sk, h, d), generator=g, device="cuda")
                .to(dt) for _ in range(2))
        scale = d ** -0.5
        out, lse = attention._fwd_dispatch(q, k, v, causal)
        torch.cuda.synchronize()
        p_out, p_lse = attention._blockwise_fwd(q, k, v, causal, scale)
        err_out = (out.float() - p_out.float()).abs().max().item()
        err_lse = (lse - p_lse).abs().max().item()
        tol = KERNEL_TOL[dtype]
        for what, got, want in (("out", out, p_out), ("lse", lse, p_lse)):
            atol, rtol = tol[what]
            if not torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=rtol):
                raise AssertionError(
                    f"kernel {what} disagrees with the plain version at "
                    f"{name}: max abs err {err_out if what == 'out' else err_lse}"
                    f" (atol {atol}, rtol {rtol})")
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"kernel output not finite at {name}")
        ms = cuda_ms(lambda: attention._fwd_dispatch(q, k, v, causal), 20)
        plain_ms = cuda_ms(
            lambda: attention._blockwise_fwd(q, k, v, causal, scale), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 20)
        bound_ms, bound_by = _attention_work("fwd", b, s, sk, h, d, causal,
                                             dtype)
        route = attention.kernel_route("fwd", dt, d)
        row = {"shape": name, "B": b, "S": s, "Sk": sk, "H": h, "D": d,
               "causal": causal, "dtype": dtype, "route": route,
               "max_abs_err": err_out,
               "max_abs_err_lse": err_lse, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        rows.append(row)
        print(f"kernel: {name} B{b} S{s} Sk{sk} H{h} D{d} causal={causal} "
              f"{dtype} [{route}]: err out {err_out:.3g} lse {err_lse:.3g}; "
              f"ms {ms:.4f} plain {plain_ms:.4f} bound {bound_ms:.4f} "
              f"({bound_by}) sdpa {library_ms:.4f}", flush=True)
        del q, k, v, out, lse, p_out, p_lse
    report["kernel_shapes"] = rows
    report["bwd_shapes"] = [_bwd_row(*shape) for shape in BWD_SHAPES]


def _bwd_row(name, b, sq, sk, h, d, causal, dtype):
    """K2 and K3 at one shape: held against _blockwise_bwd, then timed
    each alone (on the same inputs), beside the plain backward (dq, dk
    and dv in one call) and the SDPA backward (the same)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    q, do = (torch.randn((b, sq, h, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((b, sk, h, d), generator=g, device="cuda").to(dt)
            for _ in range(2))
    scale = d ** -0.5
    out, lse = attention._fwd_dispatch(q, k, v, causal)
    got = attention._kernel_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    want = attention._blockwise_bwd(q, k, v, out, lse, do, causal, scale)
    atol, rtol = BWD_TOL[dtype]
    errs = {}
    for what, x, y in zip(("dq", "dk", "dv"), got, want):
        errs[what] = (x.float() - y.float()).abs().max().item()
        if not torch.isfinite(x).all() or not torch.allclose(
                x.float(), y.float(), atol=atol, rtol=rtol):
            raise AssertionError(
                f"backward kernel {what} disagrees with the plain version "
                f"at {name}: max abs err {errs[what]} (atol {atol}, rtol "
                f"{rtol})")
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(),
                         do.float()).contiguous()
    dq_ms = cuda_ms(lambda: attention._kernel_bwd_dq(
        q, k, v, do, lse, delta, causal, scale), 20)
    dkdv_ms = cuda_ms(lambda: attention._kernel_bwd_dkdv(
        q, k, v, do, lse, delta, causal, scale), 20)
    plain_ms = cuda_ms(lambda: attention._blockwise_bwd(
        q, k, v, out, lse, do, causal, scale), 3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), 20)
    routes = {kernel: attention.kernel_route(kernel, dt, d)
              for kernel in ("dq", "dkdv")}
    row = {"shape": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
           "causal": causal, "dtype": dtype, "routes": routes,
           "max_abs_err": errs, "dq_ms": dq_ms, "dkdv_ms": dkdv_ms,
           "plain_ms": plain_ms, "library_ms": library_ms}
    for kernel in ("dq", "dkdv"):
        bound_ms, bound_by = _attention_work(kernel, b, sq, sk, h, d,
                                             causal, dtype)
        row[f"{kernel}_bound_ms"] = bound_ms
        row[f"{kernel}_bound_by"] = bound_by
    print(f"kernel: bwd {name} B{b} Sq{sq} Sk{sk} H{h} D{d} "
          f"causal={causal} {dtype} {routes}: err dq {errs['dq']:.3g} dk "
          f"{errs['dk']:.3g} dv {errs['dv']:.3g}; ms dq {dq_ms:.4f} "
          f"(bound {row['dq_bound_ms']:.4f}) dk/dv {dkdv_ms:.4f} (bound "
          f"{row['dkdv_bound_ms']:.4f}) plain {plain_ms:.4f} sdpa-bwd "
          f"{library_ms:.4f}", flush=True)
    return row


def _reset_counts() -> None:
    from ray_tpu_torch.ops import attention

    for count in (attention.launches, attention.dq_launches,
                  attention.dkdv_launches):
        count.reset()


def _read_counts() -> dict:
    from ray_tpu_torch.ops import attention

    return {"fwd": attention.launches.count,
            "dq": attention.dq_launches.count,
            "dkdv": attention.dkdv_launches.count}


def _read_routes() -> dict:
    from ray_tpu_torch.ops import attention

    return {"fwd": attention.launches.by_route,
            "dq": attention.dq_launches.by_route,
            "dkdv": attention.dkdv_launches.by_route}


def _main_path_routes(dtype: str, head_dim: int) -> dict:
    """The route each kernel must take on a main path of b1."""
    import torch

    from ray_tpu_torch.ops import attention

    return {k: attention.kernel_route(k, getattr(torch, dtype), head_dim)
            for k in ("fwd", "dq", "dkdv")}


# --------------------------------------------------------------- phase 3


class _FrozenDeps:
    """Tasks never become ready: placements are the observable state."""

    def wait_ready(self, spec, callback):
        pass


def _sched_drive(device: str, device_solve: bool, pipeline: bool):
    import numpy as np

    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch._private.ids import JobID, NodeID, TaskID
    from ray_tpu_torch.core.raylet import ClusterState, Raylet, _PendingTask
    from ray_tpu_torch.core.task_spec import (
        TaskKind,
        TaskSpec,
        scheduling_class_of,
    )

    cfg = Config.instance()
    saved = {k: getattr(cfg, k) for k in (
        "scheduler_device_solve_min_cells", "scheduler_pipeline_enabled",
        "scheduler_pipeline_debug_check")}
    cfg._set("scheduler_device_solve_min_cells", 0 if device_solve else -1)
    cfg._set("scheduler_pipeline_enabled", pipeline)
    cfg._set("scheduler_pipeline_debug_check", pipeline)
    try:
        rng = np.random.default_rng(0)
        cluster = ClusterState(device)
        deps = _FrozenDeps()
        raylets = []
        for _ in range(SCHED["nodes"]):
            resources = {"CPU": float(rng.integers(4, 32)),
                         "MEM": float(rng.integers(8, 64)),
                         "TPU": float(rng.integers(0, 4))}
            raylets.append(Raylet(NodeID.from_random(), resources,
                                  cluster, deps))
            cluster.register(raylets[-1])
        rng = np.random.default_rng(1)
        demands = []
        for c in range(SCHED["classes"]):
            d = {"CPU": float(rng.integers(1, 4))}
            if c % 3 == 0:
                d["MEM"] = float(rng.integers(1, 8))
            if c % 7 == 0:
                d["TPU"] = 1.0
            demands.append(d)
        head = raylets[0]
        job, parent = JobID.from_int(7), TaskID.for_task(None)
        names = {}
        with head._lock:
            for i in range(SCHED["tasks"]):
                spec = TaskSpec(
                    kind=TaskKind.NORMAL, task_id=TaskID.for_task(None),
                    job_id=job, parent_task_id=parent, name=f"t{i}",
                    resources=dict(demands[i % SCHED["classes"]]))
                spec.scheduling_class = scheduling_class_of(
                    spec.resource_request(cluster.ids))
                names[spec.task_id] = spec.name
                task = _PendingTask(spec, lambda r, w: None, 0)
                head._pending.append(task)
                head._by_task_id[spec.task_id] = task
        t0 = time.monotonic()
        for _ in range(256):
            head.schedule_tick()
            with head._lock:
                if not head._pending:
                    break
        wall = time.monotonic() - t0
        if head._pending:
            raise AssertionError("pending queue failed to drain")
        placements = {}
        for slot, raylet in enumerate(raylets):
            with raylet._lock:
                for tid in raylet._running:
                    placements[names[tid]] = ("run", slot)
                for q in raylet._dispatch_queues.values():
                    for task in q:
                        placements[names[task.spec.task_id]] = (
                            "queued", slot)
                for task in raylet._infeasible:
                    placements[names[task.spec.task_id]] = (
                        "infeasible", -1)
        with cluster.lock:
            cluster.refresh_locked()
            if not np.all(cluster.matrix.available >= 0):
                raise AssertionError("availability went negative")
        return placements, wall, cluster.device_mirror
    finally:
        for k, v in saved.items():
            cfg._set(k, v)


def phase_sched(report: dict) -> None:
    import torch

    from ray_tpu_torch.scheduler.policy import shared_batched_policy

    policy = shared_batched_policy(torch.device("cuda"))
    before = policy.device_solves
    dev, dev_s, _ = _sched_drive("cuda", True, False)
    single_solves = policy.device_solves - before
    ref, ref_s, _ = _sched_drive("cuda", False, False)
    if len(dev) != SCHED["tasks"] or dev != ref:
        bad = sum(1 for t in ref if dev.get(t) != ref[t])
        raise AssertionError(
            f"CUDA solve placed {bad} tasks differently from numpy")
    if single_solves == 0:
        raise AssertionError("the single-buffered drain ran no CUDA solve")
    before = policy.device_solves
    pipe, pipe_s, mirror = _sched_drive("cuda", True, True)
    pipe_solves = policy.device_solves - before
    if len(pipe) != SCHED["tasks"] or pipe_solves == 0 or mirror is None:
        raise AssertionError("pipelined drain lost tasks or ran no solve")
    # a head tick drains recursively through the spillback re-ticks, so
    # the unit of work is a batch of scheduler_max_tasks_per_tick tasks:
    # one device solve + its commit, spillback and dispatch
    from ray_tpu_torch._private.config import Config

    per_tick = Config.instance().scheduler_max_tasks_per_tick
    batches = -(-SCHED["tasks"] // per_tick)
    report["sched"] = {
        **SCHED, "batches": batches, "tasks_per_batch": per_tick,
        "single_device_s": dev_s, "single_device_solves": single_solves,
        "single_device_ms_per_batch": dev_s / batches * 1e3,
        "single_numpy_s": ref_s,
        "single_numpy_ms_per_batch": ref_s / batches * 1e3,
        "pipelined_s": pipe_s, "pipelined_solves": pipe_solves,
        "pipelined_ms_per_batch": pipe_s / batches * 1e3,
        "mirror_full_syncs": mirror.full_syncs,
        "mirror_delta_syncs": mirror.delta_syncs,
        "placements_equal": True,
    }
    print(f"sched: {SCHED['nodes']}x{SCHED['tasks']}x{SCHED['classes']} "
          f"single-buffered CUDA == numpy placements; {batches} batches "
          f"of <= {per_tick} tasks: CUDA {single_solves} solves, "
          f"{dev_s / batches * 1e3:.1f} ms/batch (numpy "
          f"{ref_s / batches * 1e3:.1f}); pipelined "
          f"{pipe_s / batches * 1e3:.1f} ms/batch, {pipe_solves} CUDA "
          f"solves, mirror {mirror.full_syncs} full + "
          f"{mirror.delta_syncs} delta syncs, drift check on", flush=True)


# --------------------------------------------------------------- phase 4


def _text_config(model: str):
    """b1, or the bench's MoE model (bench.py's sparse row)."""
    from ray_tpu_torch.models.transformer import ModelConfig

    return ModelConfig.b1() if model == "b1" else ModelConfig.moe_bench()


MODEL_DESC = {
    "b1": "ModelConfig.b1 (hidden 2048, 24 layers, 16 heads, d 128, inter "
          "5632, vocab 32000, bf16)",
    "moe": "bench MoE (hidden 1024, 8 layers, 16 heads over 8 kv heads, d "
           "64, inter 2816, top-2 of 8 experts every 2nd layer, groups "
           "4096, vocab 32000, bf16)",
    "vit": "ViTConfig.base() (ViT-B/16: hidden 768, 12 layers, 12 heads, d "
           "64, MLP 3072, 224-px images, 16-px patches, S 197, bf16)",
}


class PinnedRouting:
    """Routes a MoE model's plain-attention run as its kernel run routed.

    The kernels and the plain attention round differently, and where a
    token's top-2 router scores nearly tie the two runs send it to other
    experts, or drop it past an expert's capacity; its MoE output then
    differs by O(1) (on the card: 5.7 % of the served tokens, 2.2 % of a
    train step's (token, layer) routings; the tokens routed alike agree
    within 1.6e-2). So the two runs are compared routed alike: the MoE
    layers choose experts with ``torch.topk``, and inside ``record()``
    each call's indices are kept; inside ``replay()`` each call takes the
    indices of the recorded call at its place (values gathered from its
    own scores, so gradients flow as through top-k), and ``flips`` counts
    the routings it would have chosen otherwise."""

    def __init__(self):
        self.indices, self.flips, self.routings = [], 0, 0

    def _topk(self, scores, k, dim=-1, *args, **kwargs):
        if self._replay is None:
            out = self._torch_topk(scores, k, dim, *args, **kwargs)
            self.indices.append(out.indices)
            return out
        idx = self.indices[self._replay]
        self._replay += 1
        own = self._torch_topk(scores, k, dim).indices
        self.flips += int((own.sort(dim).values != idx.sort(dim).values)
                          .any(dim).sum())
        self.routings += own.numel() // k
        return scores.gather(dim, idx), idx

    @contextlib.contextmanager
    def _patched(self, replay):
        import torch

        self._torch_topk, self._replay = torch.topk, replay
        torch.topk = self._topk
        try:
            yield self
        finally:
            torch.topk = self._torch_topk

    def record(self):
        self.indices = []
        return self._patched(None)

    def replay(self):
        self.flips = self.routings = 0
        return self._patched(0)


class ModelServer:
    """Serves a text model (``b1`` or ``moe``) at full width and depth on
    the card."""

    def __init__(self, seed: int, model: str = "b1"):
        import torch

        from ray_tpu_torch.models import transformer as tfm
        from ray_tpu_torch.models.training import build_forward
        from ray_tpu_torch.ops.attention import blockwise_attention

        self.cfg = _text_config(model)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.params = tfm.init_params(self.cfg, gen, device="cuda")
        self.fwd = build_forward(self.cfg, device="cuda")
        self.fwd_plain = build_forward(self.cfg, device="cuda",
                                       attention_fn=blockwise_attention)

    def forward(self, tokens):
        import torch

        logits = self.fwd(self.params, tokens)
        torch.cuda.current_stream().synchronize()
        return logits

    def forward_plain(self, tokens, pinned: bool = True):
        """The plain-attention model's logits; a MoE model routed as the
        kernel model routes these tokens (PinnedRouting) unless
        ``pinned`` is false."""
        import torch

        if not (self.cfg.num_experts and pinned):
            logits = self.fwd_plain(self.params, tokens)
        else:
            pin = PinnedRouting()
            with pin.record():
                self.fwd(self.params, tokens)
            with pin.replay():
                logits = self.fwd_plain(self.params, tokens)
            self.flip_share = pin.flips / pin.routings
        torch.cuda.current_stream().synchronize()
        return logits

    def routing_flip_share(self):
        return getattr(self, "flip_share", None)


class VitServer:
    """Serves ViTConfig.base() on the card: images in, logits out."""

    def __init__(self, seed: int, model: str = "vit"):
        import torch

        from ray_tpu_torch.models import vision

        self.cfg = vision.ViTConfig.base()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.params = vision.init_params(self.cfg, gen, device="cuda")

    def _run(self, images, attention_fn):
        import torch

        from ray_tpu_torch.models import vision

        with torch.no_grad():
            logits = vision.forward(self.params, images, self.cfg,
                                    attention_fn)
        torch.cuda.current_stream().synchronize()
        return logits

    def forward(self, images):
        return self._run(images, None)

    def forward_plain(self, images):
        import functools

        from ray_tpu_torch.ops.attention import blockwise_attention

        return self._run(images, functools.partial(blockwise_attention,
                                                   causal=False))


def _vit_batch(n: int, seed: int):
    """Seeded images [n, 224, 224, 3] float32 and labels [n] in numpy."""
    import numpy as np

    from ray_tpu_torch.models.vision import ViTConfig

    cfg = ViTConfig.base()
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.channels), dtype=np.float32)
    return images, rng.integers(0, cfg.num_classes, size=n)


def phase_serve(report: dict, model: str = "b1") -> dict:
    """An actor serves ``model`` (b1, moe or vit) for SERVE_REQUESTS
    requests; returns the kernels' launches by route over them."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    if model == "vit":
        from ray_tpu_torch.models.vision import ViTConfig

        layers, head_dim = ViTConfig.base().layers, ViTConfig.base().head_dim
        batches = [_vit_batch(VIT_SERVE_IMAGES, i)[0]
                   for i in range(SERVE_REQUESTS)]
        probe, server_cls, out_shape = batches[0][:1], VitServer, (
            VIT_SERVE_IMAGES, ViTConfig.base().num_classes)
    else:
        cfg = _text_config(model)
        layers, head_dim = cfg.layers, cfg.head_dim
        rng = np.random.default_rng(0)
        batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
                   for _ in range(SERVE_REQUESTS)]
        probe, server_cls, out_shape = batches[0][:, :16], ModelServer, (
            *SERVE_TOKENS, cfg.vocab_size)
    cluster = Cluster(head_node_args={
        "num_cpus": 4, "device": "cuda",
        # logits stay on the card; keep them out of the spill path
        "_system_config": {"object_store_memory": 64 << 30}})
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=4)
        cluster.add_node(num_cpus=4, num_gpus=1)
        t0 = time.monotonic()
        server = ray_tpu_torch.remote(num_gpus=1)(server_cls).remote(
            0, model)
        # the first call includes construction (weights drawn on the card)
        ray_tpu_torch.get(server.forward.remote(probe))
        setup_s = time.monotonic() - t0
        _reset_counts()
        latencies, first, last = [], None, []
        for inputs in batches:
            t = time.monotonic()
            logits = ray_tpu_torch.get(server.forward.remote(inputs))
            latencies.append(time.monotonic() - t)
            if first is None:
                first = logits
            # the last position's logits: what proc_serve's replies hold
            last.append(logits[:, -1].float().cpu().numpy())
            del logits
        counts = _read_counts()
        routes = _read_routes()
        launches = counts["fwd"]
        if launches != layers * SERVE_REQUESTS or counts["dq"] or \
                counts["dkdv"]:
            raise AssertionError(
                f"{model}: attention kernels launched {counts} for "
                f"{SERVE_REQUESTS} requests; expected {layers} forward "
                f"launches each and no backward")
        want_route = _main_path_routes("bfloat16", head_dim)["fwd"]
        if routes["fwd"] != {want_route: launches}:
            raise AssertionError(f"{model}: served forward launches by "
                                 f"route {routes['fwd']}; expected all on "
                                 f"{want_route}")
        plain = ray_tpu_torch.get(server.forward_plain.remote(batches[0]))
        if tuple(first.shape) != out_shape or \
                not torch.isfinite(first).all():
            raise AssertionError(f"{model}: served logits malformed or not "
                                 f"finite")
        flips = free_rel = None
        if model == "moe":
            flips = ray_tpu_torch.get(server.routing_flip_share.remote())
            free = ray_tpu_torch.get(server.forward_plain.remote(
                batches[0], False))
            free_rel = ((first - free).norm() / free.norm()).item()
            del free
        rel = ((first - plain).norm() / plain.norm()).item()
        max_abs = (first - plain).abs().max().item()
        agree = (first.argmax(-1) == plain.argmax(-1)).float().mean().item()
        if not rel <= SERVE_REL_L2_TOL:
            raise AssertionError(
                f"{model}: served logits off the plain-attention model: "
                f"rel L2 {rel:.3g} > {SERVE_REL_L2_TOL}")
        shape = list(batches[0].shape)
        pinned = ("" if flips is None else
                  f" (routed alike, {flips:.4f} of the routings pinned; "
                  f"unpinned rel L2 {free_rel:.3g})")
        report["serve" if model == "b1" else f"{model}_serve"] = {
            "model": MODEL_DESC[model], "requests": SERVE_REQUESTS,
            "inputs": shape, "setup_s": setup_s, "latency_s": latencies,
            "kernel_launches": launches,
            "kernel_launches_by_route": routes["fwd"],
            "logits_rel_l2_vs_plain": rel,
            "routing_flip_share_pinned": flips,
            # not checked: each side routed by its own scores
            "logits_rel_l2_vs_plain_unpinned": free_rel,
            "logits_max_abs_vs_plain": max_abs,
            "argmax_agreement_vs_plain": agree,
            "logits_abs_max": first.abs().max().item(),
        }
        if model == "b1":
            report["_serve_last_logits"] = last
        print(f"{'serve' if model == 'b1' else model}: {model} actor "
              f"answered {SERVE_REQUESTS} requests of {shape}, latency s "
              f"{[round(x, 4) for x in latencies]}; kernel launches "
              f"{routes['fwd']}; logits vs plain attention{pinned} rel L2 "
              f"{rel:.3g}, argmax agreement {agree:.4f}", flush=True)
        del first, plain
    finally:
        cluster.shutdown()
    return routes


# --------------------------------------------------------------- phase 5


def _train_batch(model: str = "b1"):
    import numpy as np

    rng = np.random.default_rng(0)
    return rng.integers(0, _text_config(model).vocab_size,
                        size=TRAIN_TOKENS if model == "b1"
                        else MOE_TRAIN_TOKENS)


def train_b1():
    """The train function: b1 at full width and depth on this worker's
    card, TRAIN_STEPS optimizer steps on one seeded batch, each step's
    loss, grad norm and wall time reported."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.transformer import ModelConfig
    from ray_tpu_torch.models.training import build_train_step

    cfg = ModelConfig.b1()
    step, init_fn = build_train_step(cfg, device="cuda")
    params, opt_state = init_fn(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.as_tensor(_train_batch("b1"), device="cuda")
    torch.cuda.synchronize()
    for i in range(TRAIN_STEPS):
        t0 = time.monotonic()
        params, opt_state, metrics = step(params, opt_state, tokens)
        loss = metrics["loss"].item()  # waits for the step's kernels
        train.report(step=i, loss=loss,
                     grad_norm=metrics["grad_norm"].item(),
                     step_s=time.monotonic() - t0,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return train.world_rank()


def _leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of tree_leaves(tree), in its order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _loss_and_grads(params, loss_of):
    """(loss, {leaf name: grad}) of ``loss_of(params)``."""
    import torch

    from ray_tpu_torch.models.training import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_of(params)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip(_leaf_names(params), grads))


def _one_step_grads(model: str, attention_fn):
    """Gradients of a text model's loss at its seeded initial weights on
    its train batch, with ``attention_fn`` (None: the kernels)."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = _text_config(model)
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.as_tensor(_train_batch(model), device="cuda").long()
    return _loss_and_grads(
        params, lambda p: tfm.loss_fn(p, tokens, cfg, attention_fn))


def _grad_rel(grads_k: dict, grads_p: dict):
    """Relative L2 per leaf, kernels vs plain attention -> (rel by leaf,
    worst leaf)."""
    rel = {name: ((grads_k[name].float() - grads_p[name].float()).norm()
                  / grads_p[name].float().norm()).item()
           for name in grads_k}
    return rel, max(rel, key=rel.get)


def _check_grads(model: str, rel: dict, worst: str,
                 tol: float = GRAD_REL_L2_TOL) -> None:
    """Raises past ``tol`` on any leaf."""
    if not all(math.isfinite(r) for r in rel.values()) or rel[worst] > tol:
        raise AssertionError(
            f"{model}: one step's gradients on the kernels off the plain "
            f"attention: {worst} rel L2 {rel[worst]:.3g} > {tol}")


def _run_trainer(train_fn, config=None):
    """``train_fn`` through Trainer(num_workers=1, use_gpu=True) on a
    one-GPU cluster -> (reported rows, run s, launches, by route)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.cluster_utils import Cluster

    rows = []

    class Collect(train.TrainingCallback):
        def handle_result(self, results, **info):
            rows.append(results[0])

    cluster = Cluster(head_node_args={"num_cpus": 4, "num_gpus": 1,
                                      "device": "cuda"})
    try:
        trainer = train.Trainer(num_workers=1, use_gpu=True)
        trainer.start()
        _reset_counts()
        t0 = time.monotonic()
        trainer.run(train_fn, config=config, callbacks=[Collect()])
        run_s = time.monotonic() - t0
        counts = _read_counts()
        routes = _read_routes()
        trainer.shutdown()
    finally:
        cluster.shutdown()
    return rows, run_s, counts, routes


def _check_launches(model: str, counts: dict, routes: dict, want: dict,
                    head_dim: int) -> None:
    if counts != want:
        raise AssertionError(f"{model}: attention kernels launched "
                             f"{counts}; expected {want}")
    for kernel, route in _main_path_routes("bfloat16", head_dim).items():
        if routes[kernel] != {route: want[kernel]}:
            raise AssertionError(
                f"{model}: {kernel} launches by route {routes[kernel]}; "
                f"expected all {want[kernel]} on {route}")


def phase_train(report: dict) -> dict:
    from ray_tpu_torch.models.transformer import ModelConfig
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = ModelConfig.b1()
    rows, run_s, counts, routes = _run_trainer(train_b1)
    want = {"fwd": 2 * cfg.layers * TRAIN_STEPS,
            "dq": cfg.layers * TRAIN_STEPS,
            "dkdv": cfg.layers * TRAIN_STEPS}
    _check_launches("b1 train", counts, routes, want, cfg.head_dim)
    losses = [r["loss"] for r in rows]
    if len(rows) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"b1 train losses not finite and falling: "
                             f"{losses}")

    loss_k, grads_k = _one_step_grads("b1", None)
    loss_p, grads_p = _one_step_grads("b1", blockwise_attention)
    rel, worst = _grad_rel(grads_k, grads_p)
    _check_grads("b1", rel, worst)
    if abs(loss_k - losses[0]) > 1e-3 * abs(losses[0]):
        raise AssertionError(f"the replayed first step's loss {loss_k} is "
                             f"not the train run's {losses[0]}")

    steady = [r["step_s"] for r in rows[1:]]
    step_s = sum(steady) / len(steady)
    tokens = TRAIN_TOKENS[0] * (TRAIN_TOKENS[1] - 1)
    kernel_ms = {"fwd": next(r["ms"] for r in report["kernel_shapes"]
                             if r["shape"] == "train")}
    bwd = next(r for r in report["bwd_shapes"] if r["shape"] == "train")
    kernel_ms.update(dq=bwd["dq_ms"], dkdv=bwd["dkdv_ms"])
    share = {k: counts[k] / TRAIN_STEPS * kernel_ms[k] / (step_s * 1e3)
             for k in counts}
    report["train"] = {
        "model": MODEL_DESC["b1"] + ", remat full",
        "tokens": list(TRAIN_TOKENS), "steps": rows, "run_s": run_s,
        "kernel_launches": counts, "kernel_launches_by_route": routes,
        "step_s_steady": step_s,
        "tokens_per_s": tokens / step_s,
        "kernel_share_of_step_est": share,
        "grad_rel_l2_vs_plain": rel, "loss_kernels": loss_k,
        "loss_plain": loss_p,
    }
    print(f"train: b1 through Trainer(num_workers=1, use_gpu=True), "
          f"{TRAIN_STEPS} steps on {TRAIN_TOKENS[0]}x{TRAIN_TOKENS[1]} "
          f"tokens: losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(r['grad_norm'], 4) for r in rows]}, step s "
          f"{[round(r['step_s'], 4) for r in rows]}; steady {step_s:.4f} "
          f"s/step, {tokens / step_s:.0f} tokens/s, peak "
          f"{rows[-1]['peak_gib']:.1f} GiB; launches {routes}; kernel "
          f"share of a step (launches x kernel-phase ms) "
          f"{ {k: round(v, 4) for k, v in share.items()} }; grads vs "
          f"plain attention: worst rel L2 {rel[worst]:.3g} ({worst}), "
          f"loss {loss_k:.5f} vs {loss_p:.5f}", flush=True)
    return routes


# --------------------------------------------------------------- phase 6


def train_moe(config):
    """The train function of the moe phase: the bench MoE model on this
    worker's card, MOE_TRAIN_STEPS steps on one seeded batch. Before step
    MOE_CKPT_STEP it saves (params, opt_state), restores them onto a
    fresh init through ``like`` and checks every leaf equal, takes that
    step once on the state that never stopped (its loss is reported as
    ``uninterrupted_loss``) and goes on from the restored state."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.training import build_train_step, tree_leaves
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = _text_config("moe")
    step, init_fn = build_train_step(cfg, device="cuda")
    params, opt_state = init_fn(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.as_tensor(_train_batch("moe"), device="cuda")
    ckpt = CheckpointManager(config["ckpt_dir"], max_to_keep=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(MOE_TRAIN_STEPS):
        extra = {}
        if i == MOE_CKPT_STEP:
            t0 = time.monotonic()
            ckpt.save(i, {"params": params, "opt_state": opt_state})
            extra["save_s"] = time.monotonic() - t0
            fresh_p, fresh_o = init_fn(
                torch.Generator(device="cuda").manual_seed(1))
            t0 = time.monotonic()
            restored = ckpt.restore(i, like={"params": fresh_p,
                                             "opt_state": fresh_o})
            torch.cuda.synchronize()
            extra["restore_s"] = time.monotonic() - t0
            del fresh_p, fresh_o
            saved = tree_leaves(params) + opt_state["mu"] + opt_state["nu"]
            got = (tree_leaves(restored["params"])
                   + restored["opt_state"]["mu"]
                   + restored["opt_state"]["nu"])
            unequal = [n for n, (a, b) in enumerate(zip(got, saved))
                       if not torch.equal(a, b.detach())]
            if len(got) != len(saved) or unequal or \
                    restored["opt_state"]["count"] != opt_state["count"]:
                raise AssertionError(
                    f"moe: the restored train state differs from the saved "
                    f"one ({len(got)} vs {len(saved)} leaves, unequal at "
                    f"{unequal[:5]}, count {restored['opt_state']['count']}"
                    f" vs {opt_state['count']})")
            extra["restored_leaves_equal"] = len(got)
            _, _, metrics = step(params, opt_state, tokens)
            extra["uninterrupted_loss"] = metrics["loss"].item()
            params, opt_state = restored["params"], restored["opt_state"]
            del restored, saved, got, metrics
        t0 = time.monotonic()
        params, opt_state, metrics = step(params, opt_state, tokens)
        loss = metrics["loss"].item()  # waits for the step's kernels
        step_s = time.monotonic() - t0
        if i == MOE_TRAIN_STEPS - 1:
            # the aux loss of the trained weights, on the plain attention
            # (no kernel launch outside the counted steps)
            with torch.no_grad():
                _, aux = tfm.hidden_states(params, tokens[:2, :-1], cfg,
                                           blockwise_attention)
            extra["aux"] = aux.item()
        train.report(step=i, loss=loss,
                     grad_norm=metrics["grad_norm"].item(), step_s=step_s,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     **extra)
    ckpt.close()
    return train.world_rank()


def phase_moe(report: dict) -> dict:
    """The MoE model's train path (its serve path is phase_serve's)."""
    import shutil

    import torch

    from ray_tpu_torch.ops.attention import blockwise_attention

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the MoE dispatch and combine "
                             "must run in fp32")
    cfg = _text_config("moe")
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            CKPT_DIR)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        rows, run_s, counts, routes = _run_trainer(
            train_moe, {"ckpt_dir": ckpt_dir})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps_run = MOE_TRAIN_STEPS + 1  # the uninterrupted step besides
    want = {"fwd": 2 * cfg.layers * steps_run,
            "dq": cfg.layers * steps_run, "dkdv": cfg.layers * steps_run}
    _check_launches("moe train", counts, routes, want, cfg.head_dim)
    losses = [r["loss"] for r in rows]
    if len(rows) != MOE_TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe train losses not finite and falling: "
                             f"{losses}")
    aux = rows[-1]["aux"]
    resumed = rows[MOE_CKPT_STEP]
    pin = PinnedRouting()
    with pin.record():
        loss_k, grads_k = _one_step_grads("moe", None)
    with pin.replay():
        loss_p, grads_p = _one_step_grads("moe", blockwise_attention)
    rel, worst = _grad_rel(grads_k, grads_p)
    flip_share = pin.flips / pin.routings
    del grads_p
    # not checked: the plain run routed by its own scores
    _, grads_f = _one_step_grads("moe", blockwise_attention)
    rel_free, worst_free = _grad_rel(grads_k, grads_f)
    del grads_k, grads_f
    steady = [r["step_s"] for r in rows[1:]]
    step_s = sum(steady) / len(steady)
    tokens = MOE_TRAIN_TOKENS[0] * (MOE_TRAIN_TOKENS[1] - 1)
    report["moe_train"] = {
        "model": MODEL_DESC["moe"] + ", remat full, logits_chunk 256",
        "tokens": list(MOE_TRAIN_TOKENS), "steps": rows, "run_s": run_s,
        "steps_run": steps_run, "kernel_launches": counts,
        "kernel_launches_by_route": routes, "step_s_steady": step_s,
        "tokens_per_s": tokens / step_s, "aux": aux,
        "checkpoint": {k: resumed[k] for k in (
            "save_s", "restore_s", "restored_leaves_equal",
            "uninterrupted_loss")},
        "grad_rel_l2_vs_plain": rel, "loss_kernels": loss_k,
        "loss_plain": loss_p, "routing_flip_share_pinned": flip_share,
        "grad_rel_l2_vs_plain_unpinned": rel_free,
    }
    print(f"moe: Trainer(num_workers=1, use_gpu=True), {MOE_TRAIN_STEPS} "
          f"steps on {MOE_TRAIN_TOKENS[0]}x{MOE_TRAIN_TOKENS[1]} tokens "
          f"(+1 uninterrupted): losses {[round(x, 4) for x in losses]}, "
          f"aux {aux:.4f}, step s {[round(r['step_s'], 4) for r in rows]}; "
          f"steady {step_s:.4f} s/step, {tokens / step_s:.0f} tokens/s, "
          f"peak {rows[-1]['peak_gib']:.1f} GiB; checkpoint after step "
          f"{MOE_CKPT_STEP}: {resumed['restored_leaves_equal']} leaves "
          f"restored equal (save {resumed['save_s']:.2f} s, restore "
          f"{resumed['restore_s']:.2f} s), next loss {resumed['loss']:.6f} "
          f"vs uninterrupted {resumed['uninterrupted_loss']:.6f}; launches "
          f"{routes}; grads vs plain attention routed alike: worst rel L2 "
          f"{rel[worst]:.3g} ({worst}), loss {loss_k:.5f} vs {loss_p:.5f}, "
          f"{flip_share:.4f} of the routings pinned (unpinned worst rel L2 "
          f"{rel_free[worst_free]:.3g}, {worst_free})", flush=True)
    torch.cuda.empty_cache()
    if not (math.isfinite(aux) and aux > 0):
        raise AssertionError(f"moe aux loss {aux} is not finite and > 0")
    if abs(resumed["loss"] - resumed["uninterrupted_loss"]) > \
            1e-3 * abs(resumed["loss"]):
        raise AssertionError(
            f"moe: the step after the restore took loss {resumed['loss']}, "
            f"the uninterrupted run {resumed['uninterrupted_loss']}")
    _check_grads("moe", rel, worst)
    if abs(loss_k - losses[0]) > 1e-3 * abs(losses[0]):
        raise AssertionError(f"moe: the replayed first step's loss {loss_k} "
                             f"is not the train run's {losses[0]}")
    return routes


def _merge_routes(*parts: dict) -> dict:
    """Launches by kernel and route, summed over the parts of a path."""
    merged = {k: {} for k in ("fwd", "dq", "dkdv")}
    for part in parts:
        for kernel, by_route in part.items():
            for route, n in by_route.items():
                merged[kernel][route] = merged[kernel].get(route, 0) + n
    return merged


# --------------------------------------------------------------- phase 7


def phase_vit(report: dict) -> dict:
    """ViT-B/16's train path (its serve path is phase_serve's)."""
    import functools

    import torch

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.models.training import make_optimizer, tree_leaves
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = vision.ViTConfig.base()
    images, labels = (torch.as_tensor(a, device="cuda")
                      for a in _vit_batch(VIT_TRAIN_IMAGES, 100))
    params = vision.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = make_optimizer()
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rows = []
    for _ in range(VIT_TRAIN_STEPS):
        t0 = time.monotonic()
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = vision.loss_fn(params, images, labels, cfg)
        norm = opt.update(params, torch.autograd.grad(loss, leaves), state)
        rows.append({"loss": loss.item(), "grad_norm": norm.item(),
                     "step_s": time.monotonic() - t0})
    counts = _read_counts()
    routes = _read_routes()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {k: cfg.layers * VIT_TRAIN_STEPS for k in ("fwd", "dq", "dkdv")}
    _check_launches("vit train", counts, routes, want, cfg.head_dim)
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"vit train losses not finite and falling: "
                             f"{losses}")
    del params, state

    def vit_grads(attention_fn):
        params = vision.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        return _loss_and_grads(params, lambda p: vision.loss_fn(
            p, images, labels, cfg, attention_fn))

    loss_k, grads_k = vit_grads(None)
    loss_p, grads_p = vit_grads(functools.partial(blockwise_attention,
                                                  causal=False))
    rel, worst = _grad_rel(grads_k, grads_p)
    steady = [r["step_s"] for r in rows[1:]]
    step_s = sum(steady) / len(steady)
    report["vit_train"] = {
        "model": MODEL_DESC["vit"], "images": VIT_TRAIN_IMAGES,
        "steps": rows, "kernel_launches": counts,
        "kernel_launches_by_route": routes, "step_s_steady": step_s,
        "images_per_s": VIT_TRAIN_IMAGES / step_s, "peak_gib": peak_gib,
        "grad_rel_l2_vs_plain": rel, "loss_kernels": loss_k,
        "loss_plain": loss_p,
    }
    print(f"vit: {VIT_TRAIN_STEPS} ClippedAdamW steps on {VIT_TRAIN_IMAGES} "
          f"images: losses {[round(x, 4) for x in losses]}, step s "
          f"{[round(r['step_s'], 4) for r in rows]}; steady {step_s:.4f} "
          f"s/step, {VIT_TRAIN_IMAGES / step_s:.0f} images/s, peak "
          f"{peak_gib:.1f} GiB; launches {routes}; grads vs plain "
          f"attention: worst rel L2 {rel[worst]:.3g} ({worst}), loss "
          f"{loss_k:.5f} vs {loss_p:.5f}", flush=True)
    del grads_k, grads_p
    torch.cuda.empty_cache()
    _check_grads("vit", rel, worst)
    if abs(loss_k - losses[0]) > 1e-3 * abs(losses[0]):
        raise AssertionError(f"vit: the replayed first step's loss {loss_k} "
                             f"is not the train run's {losses[0]}")
    return routes


# --------------------------------------------------------------- phase 8


DEBUG_TOKENS = (2, 129)  # [B, S + 1]: next-token targets at max_seq 128
DEBUG_IMAGES = 8


def _routed_alike(cfg):
    """(record, replay) contexts: a MoE model's plain run routed as its
    kernel run (PinnedRouting), nothing for a dense one."""
    if not cfg.num_experts:
        return contextlib.nullcontext(), contextlib.nullcontext()
    pin = PinnedRouting()
    return pin.record(), pin.replay()


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def _debug_text(name: str) -> dict:
    """ModelConfig.debug() or tiny_moe() (the JAX package's test
    configs, float32, head_dim 16) on the card: served logits and one
    step's gradients through the kernels, each held against the plain
    attention (a MoE model routed alike), then one optimizer step."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_forward, build_train_step
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = getattr(tfm.ModelConfig, name)()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=DEBUG_TOKENS), device="cuda")
    record, replay = _routed_alike(cfg)
    with torch.no_grad():
        with record:
            logits = build_forward(cfg, device="cuda")(params, tokens[:, :-1])
        with replay:
            plain = build_forward(cfg, device="cuda",
                                  attention_fn=blockwise_attention)(
                params, tokens[:, :-1])
    serve_rel = _rel_l2(logits, plain)
    if tuple(logits.shape) != (DEBUG_TOKENS[0], DEBUG_TOKENS[1] - 1,
                               cfg.vocab_size) or \
            not torch.isfinite(logits).all() or \
            not serve_rel <= DEBUG_REL_L2_TOL:
        raise AssertionError(f"debug {name}: served logits malformed or off "
                             f"the plain attention (rel L2 {serve_rel:.3g})")
    record, replay = _routed_alike(cfg)
    with record:
        loss_k, grads_k = _loss_and_grads(
            params, lambda p: tfm.loss_fn(p, tokens, cfg, None))
    with replay:
        loss_p, grads_p = _loss_and_grads(
            params, lambda p: tfm.loss_fn(p, tokens, cfg,
                                          blockwise_attention))
    rel, worst = _grad_rel(grads_k, grads_p)
    _check_grads(f"debug {name}", rel, worst, DEBUG_REL_L2_TOL)
    step, init_fn = build_train_step(cfg, device="cuda")
    p, o = init_fn(torch.Generator(device="cuda").manual_seed(0))
    _, _, metrics = step(p, o, tokens)
    step_loss = metrics["loss"].item()
    if not math.isfinite(step_loss):
        raise AssertionError(f"debug {name}: train step loss {step_loss}")
    return {"serve_rel_l2_vs_plain": serve_rel, "loss_kernels": loss_k,
            "loss_plain": loss_p, "grad_worst_rel_l2": rel[worst],
            "grad_worst_leaf": worst, "train_step_loss": step_loss}


def phase_debug(report: dict) -> dict:
    """The JAX package's test configs on the card through the kernels
    (head_dim 16, float32: the FMA route): ModelConfig.debug() and
    tiny_moe() served and one train step of each, ViTConfig.debug()
    served, each against the plain attention."""
    import functools

    import numpy as np
    import torch

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.ops.attention import blockwise_attention

    _reset_counts()
    rows = {name: _debug_text(name) for name in ("debug", "tiny_moe")}
    cfg = vision.ViTConfig.debug()
    params = vision.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    images = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (DEBUG_IMAGES, cfg.image_size, cfg.image_size, cfg.channels),
        dtype=np.float32), device="cuda")
    with torch.no_grad():
        logits = vision.forward(params, images, cfg, None)
        plain = vision.forward(params, images, cfg, functools.partial(
            blockwise_attention, causal=False))
    rows["vit_debug"] = {"serve_rel_l2_vs_plain": _rel_l2(logits, plain)}
    counts, routes = _read_counts(), _read_routes()
    if not torch.isfinite(logits).all() or \
            not rows["vit_debug"]["serve_rel_l2_vs_plain"] <= \
            DEBUG_REL_L2_TOL:
        raise AssertionError(f"debug vit: logits off the plain attention: "
                             f"{rows['vit_debug']}")
    want = _main_path_routes("float32", cfg.head_dim)
    for kernel, route in want.items():
        if not counts[kernel] or routes[kernel] != {route: counts[kernel]}:
            raise AssertionError(f"debug: {kernel} launches by route "
                                 f"{routes[kernel]}; expected some, all on "
                                 f"{route}")
    report["debug"] = {"configs": rows, "kernel_launches": counts,
                       "kernel_launches_by_route": routes}
    print(f"debug: ModelConfig.debug, tiny_moe (routed alike) and "
          f"ViTConfig.debug on the card, head_dim 16 float32: "
          f"{ {k: {m: (round(v, 8) if isinstance(v, float) else v) for m, v in r.items()} for k, r in rows.items()} }; "
          f"launches {routes}", flush=True)
    return routes


# --------------------------------------------------------------- phase 9


class ProcServer(ModelServer):
    """ModelServer in an actor's own OS process (the process tier). Its
    replies are the last position's logits as host arrays, [2, 32000]
    float32 (256 KB, past the pipe protocol's SHM_THRESHOLD), so each
    rides the pool's shm segment; the launch counts it reads are those of
    its own process, where its kernels run."""

    def pid(self):
        return os.getpid()

    def visible_devices(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def forward_last(self, tokens):
        return self.forward(tokens)[:, -1].float().cpu().numpy()

    def rel_l2_vs_plain(self, tokens):
        return _rel_l2(self.forward(tokens), self.forward_plain(tokens))

    def reset_counts(self):
        _reset_counts()

    def counts(self):
        return _read_counts(), _read_routes()


def _no_card_build():
    """In a device-less pool worker: the port's CUDA entry point raises."""
    import torch

    from ray_tpu_torch.models.training import build_forward
    from ray_tpu_torch.models.transformer import ModelConfig

    seen = (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch.cuda.device_count())
    try:
        build_forward(ModelConfig.b1())
    except RuntimeError as exc:
        return seen, str(exc)
    return seen, None


def phase_proc_serve(report: dict) -> dict:
    """b1 served from an actor's own OS process on the card, through K1,
    its replies through the port's shm segment, held against the thread
    tier's serve phase; and a device-less pool worker's CUDA entry point
    raising (the device rule, shown with a card present)."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._native.shm_store import ShmStore

    want_last = report.get("_serve_last_logits")
    if want_last is None:
        raise AssertionError("proc_serve needs the serve phase's logits")
    cfg = _text_config("b1")
    rng = np.random.default_rng(0)  # the serve phase's tokens
    batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
               for _ in range(SERVE_REQUESTS)]
    moved = []  # bytes of each shm buffer this process read off a pipe
    get_bytes = ShmStore.get_bytes

    def counting_get_bytes(store, object_id):
        data = get_bytes(store, object_id)
        if data is not None:
            moved.append(len(data))
        return data

    ShmStore.get_bytes = counting_get_bytes
    override = "RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES"
    os.environ.pop(override, None)  # the pool's task workers: no card
    rt = ray_tpu_torch.init(worker_mode="process", num_process_workers=2,
                            num_gpus=1)
    try:
        shm_path = rt.process_pool.shm_path
        if not shm_path:
            raise AssertionError("the process pool has no shm segment")
        os.environ[override] = "0"  # the actor's process is given card 0
        t0 = time.monotonic()
        server = ray_tpu_torch.remote(num_gpus=1)(ProcServer).remote(0, "b1")
        pid = ray_tpu_torch.get(server.pid.remote())
        # the first forward, as the serve phase's probe: part of start-up
        ray_tpu_torch.get(server.forward_last.remote(batches[0][:, :16]))
        startup_s = time.monotonic() - t0
        visible = ray_tpu_torch.get(server.visible_devices.remote())
        if pid == os.getpid():
            raise AssertionError("the actor runs in the driver's process")
        ray_tpu_torch.get(server.reset_counts.remote())
        moved.clear()
        latencies, last = [], []
        for tokens in batches:
            t = time.monotonic()
            last.append(ray_tpu_torch.get(server.forward_last.remote(tokens)))
            latencies.append(time.monotonic() - t)
        counts, routes = ray_tpu_torch.get(server.counts.remote())
        shm_reads, shm_bytes = len(moved), sum(moved)
        want_route = _main_path_routes("bfloat16", cfg.head_dim)["fwd"]
        if counts != {"fwd": cfg.layers * SERVE_REQUESTS, "dq": 0,
                      "dkdv": 0} or routes["fwd"] != {
                          want_route: cfg.layers * SERVE_REQUESTS}:
            raise AssertionError(f"proc_serve: the actor's kernels launched "
                                 f"{counts} by route {routes}; expected "
                                 f"{cfg.layers} forward launches a request "
                                 f"on {want_route}")
        if shm_reads < SERVE_REQUESTS or any(
                x.nbytes < 256 * 1000 for x in last):
            raise AssertionError(f"proc_serve: {shm_reads} shm reads for "
                                 f"{SERVE_REQUESTS} replies")
        rel = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
                  for g, w in zip(last, want_last))
        bitwise = all(np.array_equal(g, w) for g, w in zip(last, want_last))
        if not all(g.shape == (SERVE_TOKENS[0], cfg.vocab_size)
                   and np.isfinite(g).all() for g in last) or \
                not rel <= SERVE_REL_L2_TOL:
            raise AssertionError(f"proc_serve: logits off the thread tier's "
                                 f"(rel L2 {rel:.3g})")
        child_rel = ray_tpu_torch.get(server.rel_l2_vs_plain.remote(
            batches[0]))
        if not child_rel <= SERVE_REL_L2_TOL:
            raise AssertionError(f"proc_serve: the actor's logits off its "
                                 f"plain attention: rel L2 {child_rel:.3g}")
        ray_tpu_torch.kill(server)
        os.environ.pop(override, None)
        (seen, error) = ray_tpu_torch.get(
            ray_tpu_torch.remote(_no_card_build).remote())
        if seen != ("", 0) or not error or "no CUDA device" not in error:
            raise AssertionError(f"proc_serve: a device-less pool worker saw "
                                 f"{seen} and build_forward gave {error!r}")
    finally:
        os.environ.pop(override, None)
        ShmStore.get_bytes = get_bytes
        ray_tpu_torch.shutdown()
    report["proc_serve"] = {
        "model": MODEL_DESC["b1"], "requests": SERVE_REQUESTS,
        "inputs": list(SERVE_TOKENS), "actor_pid_differs": True,
        "actor_visible_devices": visible, "startup_s": startup_s,
        "latency_s": latencies,
        "thread_tier_latency_s": report["serve"]["latency_s"],
        "shm_path": shm_path, "shm_reads": shm_reads,
        "shm_bytes": shm_bytes, "kernel_launches": counts,
        "kernel_launches_by_route": routes,
        "last_logits_rel_l2_vs_thread_tier": rel,
        "last_logits_bitwise_equal_thread_tier": bitwise,
        "logits_rel_l2_vs_plain_in_actor": child_rel,
        "device_less_worker": {"visible_devices": seen[0],
                               "device_count": seen[1], "error": error},
    }
    print(f"proc_serve: on {report.get('card')}: b1 actor in its own process "
          f"(pid {pid}, "
          f"CUDA_VISIBLE_DEVICES={visible!r}) up (first forward included) "
          f"in {startup_s:.2f} s; "
          f"{SERVE_REQUESTS} requests of {list(SERVE_TOKENS)}, latency s "
          f"{[round(x, 4) for x in latencies]} (thread tier "
          f"{[round(x, 4) for x in report['serve']['latency_s']]}); "
          f"{shm_reads} replies, {shm_bytes} bytes through the shm segment; "
          f"launches in the actor {routes}; last-position logits vs the "
          f"thread tier rel L2 {rel:.3g}, bitwise equal {bitwise}; full "
          f"logits vs plain attention in the actor rel L2 {child_rel:.3g}; "
          f"device-less pool worker saw {seen} and raised {error[:60]!r}",
          flush=True)
    return routes


# -------------------------------------------------------------- phase 4c


class BurstActor:
    """One of the live cluster's {"CPU": 0.25} burst actors."""

    def __init__(self, i):
        self.i = i

    def ping(self):
        return self.i


def _array_sum(array):
    return int(array.sum())


def _pool_ready(pool: dict) -> bool:
    return pool["alive"] == pool["size"] and \
        pool["warm_idle"] >= pool["warm_size"]


def _burst(client, n: int, tag: str) -> list:
    """``n`` {"CPU": 0.25} actors in one actor_create_batch frame; the
    GCS's views of them once every one is ALIVE."""
    from ray_tpu_torch.cluster import protocol

    rows = [{"actor_id": f"{tag}{i:03d}",
             "cls_bytes": protocol.dumps(BurstActor),
             "args_bytes": protocol.dumps(([("v", protocol.dumps(i))], {})),
             "resources": {"CPU": 0.25}, "max_restarts": 0, "name": "",
             "token": f"{tag}-row{i}"} for i in range(n)]
    client.gcs.call("actor_create_batch", creates=rows, token=tag,
                    timeout=120.0)
    deadline = time.monotonic() + 120
    while True:
        views = [client.gcs.call("actor_get", actor_id=r["actor_id"])
                 for r in rows]
        if all(v["state"] == "ALIVE" for v in views):
            return views
        if time.monotonic() > deadline:
            raise AssertionError(f"cluster: burst actors not ALIVE: "
                                 f"{sorted({v['state'] for v in views})}")
        time.sleep(0.1)


def _maps_cuda(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libcuda.so" in f.read()


def _descendants(roots) -> set:
    """Every live process under ``roots`` (the cluster's server pids)."""
    parent = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        parent[int(entry)] = int(fields[1])
    out, frontier = set(), set(roots)
    while frontier:
        frontier = {p for p, pp in parent.items()
                    if pp in frontier and p not in out}
        out |= frontier
    return out


def _reap(pids, timeout: float = 15.0) -> list:
    """Wait for ``pids`` to exit; SIGKILL the ones still alive after
    ``timeout``. Returns the pids that had to be killed."""
    import signal

    def alive(pid):
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(alive(p) for p in pids):
        time.sleep(0.1)
    killed = [p for p in pids if alive(p)]
    for p in killed:
        with contextlib.suppress(ProcessLookupError):
            os.kill(p, signal.SIGKILL)
    return killed


def _placer_state(gcs_server):
    """A state-only GcsService (as tests/test_device_scheduler_live.py
    builds it) over CLUSTER_PLACER["nodes"] seeded nodes, and the burst's
    CLUSTER_PLACER["classes"] demand classes."""
    import threading

    import numpy as np

    rng = np.random.default_rng(0)
    svc = gcs_server.GcsService.__new__(gcs_server.GcsService)
    svc._lock = threading.RLock()
    svc._nodes = {}
    for i in range(CLUSTER_PLACER["nodes"]):
        res = {"CPU": float(rng.choice([32, 64, 96, 128])),
               "memory": float(rng.choice([128, 256, 512])) * 2 ** 30}
        if i % 4 == 0:
            res["GPU"] = float(rng.choice([1, 2, 4, 8]))
        rec = gcs_server._NodeRecord(f"node{i:04d}",
                                     f"10.0.{i // 200}.{i % 200}:7000", res)
        rec.available = {k: (float(np.floor(v * rng.uniform(0.5, 1.0)))
                             if k != "memory" else v * rng.uniform(0.5, 1.0))
                         for k, v in res.items()}
        svc._nodes[rec.node_id] = rec
    demands = []
    for c in range(CLUSTER_PLACER["classes"]):
        d = {"CPU": float(rng.choice([0.25, 0.5, 1, 2])) + c * 1e-3}
        if c % 4 == 1:
            d["GPU"] = float(rng.choice([0.25, 0.5]))
        if c % 3 == 2:
            d["memory"] = float(rng.choice([1, 2, 4])) * 2 ** 30
        demands.append(d)
    return svc, demands


def _placer_bursts() -> dict:
    """The GCS's actor-burst placer (A3) on the card at the scheduler's
    verdict scale, against its numpy route on the same state."""
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch.cluster import gcs_server
    from ray_tpu_torch.scheduler.policy import shared_batched_policy

    knob = "RAY_TPU_scheduler_device_solve_min_cells"
    svc, demands = _placer_state(gcs_server)

    def burst():
        return [gcs_server._ActorRecord(f"a{i:05d}", b"", b"",
                                        demands[i % len(demands)], 0)
                for i in range(CLUSTER_PLACER["actors"])]

    def timed(n):
        maps, ms = [], []
        for _ in range(n):
            actors = burst()
            t = time.perf_counter()
            maps.append(svc._batch_assign_actors(actors))
            ms.append((time.perf_counter() - t) * 1e3)
        return maps, ms

    policy = shared_batched_policy("cuda")
    solves0 = policy.device_solves
    os.environ.pop(knob, None)  # the default routing: 8,192 cells
    Config.reset()
    dev_maps, dev_ms = timed(CLUSTER_PLACER["bursts"] + 1)  # first warms
    device_solves = policy.device_solves - solves0
    os.environ[knob] = "-1"  # the numpy route
    Config.reset()
    try:
        np_maps, np_ms = timed(CLUSTER_PLACER["bursts"])
    finally:
        os.environ.pop(knob, None)
        Config.reset()
    if policy.device_solves - solves0 != device_solves:
        raise AssertionError("the numpy route launched a device solve")
    if device_solves != CLUSTER_PLACER["bursts"] + 1:
        raise AssertionError(f"placer: {device_solves} device solves for "
                             f"{CLUSTER_PLACER['bursts'] + 1} bursts")
    want = np_maps[0]
    if any(m != want for m in dev_maps + np_maps) or not want:
        raise AssertionError("placer: the device map differs from numpy's")
    return {"nodes": CLUSTER_PLACER["nodes"],
            "actors": CLUSTER_PLACER["actors"],
            "classes": CLUSTER_PLACER["classes"],
            "placed": len(want), "device_solves": device_solves,
            "device_ms": dev_ms, "numpy_ms": np_ms,
            "maps_equal": True}


def phase_cluster(report: dict) -> dict:
    """The multi-process cluster on the card: the GCS burst placer (A3)
    on CUDA against numpy; a live ProcessCluster at its default settings
    (the GCS on CUDA, warmed at start; 50 ms heartbeats, 10 missed make
    a node dead) whose GCS takes bursts through its device solve; b1
    served from a raylet's worker through K1; one cross-node object."""
    import numpy as np

    from ray_tpu_torch.cluster import process_cluster as pc
    from ray_tpu_torch.cluster import protocol
    from ray_tpu_torch.cluster.byte_store import sweep_stale_segments

    want_last = report.get("_serve_last_logits")
    if want_last is None:
        raise AssertionError("cluster needs the serve phase's logits")
    placer = _placer_bursts()
    print(f"cluster: on {report.get('card')}: GCS placer "
          f"{placer['nodes']} nodes x {placer['actors']} actors x "
          f"{placer['classes']} classes, {placer['placed']} placed, maps "
          f"equal; ms a burst on CUDA {[round(x, 2) for x in placer['device_ms']]}"
          f" (the first warms), numpy "
          f"{[round(x, 2) for x in placer['numpy_ms']]}", flush=True)

    cfg = _text_config("b1")
    rng = np.random.default_rng(0)  # the serve phase's tokens
    batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
               for _ in range(SERVE_REQUESTS)]
    override = "RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES"
    os.environ[override] = "0"  # the raylets' workers get card 0
    cluster = client = None
    started, out = set(), {"placer": placer}
    try:
        t = time.monotonic()
        cluster = pc.ProcessCluster(
            gcs_env={"RAY_TPU_scheduler_device_solve_min_cells": "0"})
        gcs_start_s = time.monotonic() - t
        cpu_node = cluster.add_node(
            num_cpus=8, object_store_memory=CLUSTER_STORE_BYTES)
        gpu_node = cluster.add_node(
            num_cpus=8, resources={"GPU": 1},
            object_store_memory=CLUSTER_STORE_BYTES)
        cluster.wait_for_nodes(2)
        client = pc.ClusterClient(cluster.gcs_address)
        gcs_pid = cluster.gcs_proc.pid
        # the raylets' worker pools booted: the burst meets an idle host
        deadline = time.monotonic() + 60
        while not all(
                _pool_ready(cluster.node_stats(n)["pool"])
                for n in (cpu_node, gpu_node)):
            if time.monotonic() > deadline:
                raise AssertionError("cluster: worker pools not booted")
            time.sleep(0.1)

        # the GCS took its CUDA context at start (warm_device) and the
        # raylets, which run no solve, took none
        cuda_maps = {"gcs": _maps_cuda(gcs_pid),
                     "raylets": [_maps_cuda(p.pid)
                                 for p in cluster.raylets.values()]}
        if not cuda_maps["gcs"] or any(cuda_maps["raylets"]):
            raise AssertionError(f"cluster: libcuda.so mapped in {cuda_maps}"
                                 f"; expected the GCS alone")
        gap0 = {n: v["heartbeat_max_gap_ms"]
                for n, v in client.cluster_view()["nodes"].items()}
        # bursts of actors through actor_create_batch
        t = time.monotonic()
        first = _burst(client, CLUSTER_BURST, "burst")
        burst_s = time.monotonic() - t
        t = time.monotonic()
        second = _burst(client, CLUSTER_BURST // 2, "again")
        again_s = time.monotonic() - t
        view = client.cluster_view()
        placement = view["actor_placement"]
        gaps = {n: v["heartbeat_max_gap_ms"] for n, v in view["nodes"].items()}
        timeout_ms = 50 * 10  # ProcessCluster's defaults
        alive = [v["alive"] for v in view["nodes"].values()]
        if not all(alive) or max(gaps.values()) >= timeout_ms:
            raise AssertionError(f"cluster: a node's heartbeats fell "
                                 f"behind in the bursts: gaps ms {gaps}, "
                                 f"alive {alive}")
        per_node = {}
        for v in first + second:
            per_node[v["node_id"]] = per_node.get(v["node_id"], 0) + 1
        if max(per_node.values()) * 0.25 > 8 or \
                not set(per_node) <= {cpu_node, gpu_node}:
            raise AssertionError(f"cluster: burst placed beyond capacity: "
                                 f"{per_node}")
        if not str(placement.get("device", "")).startswith("cuda") or \
                placement.get("device_solves", 0) < 2 or \
                placement.get("host_solves"):
            raise AssertionError(f"cluster: the GCS's burst solves did not "
                                 f"all run on CUDA: {placement}")
        for v in first + second:
            client.kill_actor(pc.ClusterActorHandle(client, v["actor_id"]))
        solves = placement["device_ms"]
        out["burst"] = {
            "actors": [CLUSTER_BURST, CLUSTER_BURST // 2],
            "alive_s": [burst_s, again_s],
            "per_node": {n[:8]: k for n, k in per_node.items()},
            "gcs_placement": placement, "gcs_pid": gcs_pid,
            "gcs_start_s": gcs_start_s, "libcuda_mapped": cuda_maps,
            "heartbeat_max_gap_ms": {"before": max(gap0.values()),
                                     "after": max(gaps.values()),
                                     "timeout": timeout_ms}}
        print(f"cluster: GCS (pid {gcs_pid}) up in {gcs_start_s:.2f} s, its "
              f"CUDA solve warmed at start in "
              f"{placement['warmup_ms']:.1f} ms (libcuda.so mapped in the "
              f"GCS, in no raylet); bursts of {CLUSTER_BURST} and "
              f"{CLUSTER_BURST // 2} actors ALIVE in {burst_s:.2f} s and "
              f"{again_s:.2f} s through actor_create_batch, per node "
              f"{sorted(per_node.values())}; solved on "
              f"{placement['device']}, ms (actors) "
              f"{[(round(m, 2), n) for m, n in solves]}; longest heartbeat "
              f"gap ms {max(gap0.values()):.1f} before the bursts, "
              f"{max(gaps.values()):.1f} after (timeout {timeout_ms}), "
              f"every node alive", flush=True)

        # b1 from a raylet's worker
        t0 = time.monotonic()
        server = client.create_actor(ProcServer, (0, "b1"),
                                     resources={"GPU": 1})
        pid = server.pid()
        server.forward_last(batches[0][:, :16])  # the probe
        startup_s = time.monotonic() - t0
        host = client.gcs.call("actor_get", actor_id=server.actor_id)
        if host["node_id"] != gpu_node or pid == os.getpid():
            raise AssertionError(f"cluster: the b1 actor is not in a "
                                 f"worker of the GPU node: {host}")
        server.reset_counts()
        reply_bytes = []
        loads = protocol.loads

        def counting_loads(data):
            if isinstance(data, (bytes, bytearray, memoryview)):
                reply_bytes.append(len(data))
            return loads(data)

        latencies, last = [], []
        protocol.loads = counting_loads
        try:
            for tokens in batches:
                reply_bytes.clear()
                t = time.monotonic()
                last.append(server.forward_last(tokens))
                latencies.append(time.monotonic() - t)
        finally:
            protocol.loads = loads
        counts, routes = server.counts()
        want_route = _main_path_routes("bfloat16", cfg.head_dim)["fwd"]
        if counts != {"fwd": cfg.layers * SERVE_REQUESTS, "dq": 0,
                      "dkdv": 0} or routes["fwd"] != {
                          want_route: cfg.layers * SERVE_REQUESTS}:
            raise AssertionError(f"cluster: the actor's kernels launched "
                                 f"{counts} by route {routes}; expected "
                                 f"{cfg.layers} forward launches a request "
                                 f"on {want_route}")
        bitwise = all(np.array_equal(g, w) for g, w in zip(last, want_last))
        if not bitwise or not all(
                g.shape == (SERVE_TOKENS[0], cfg.vocab_size) for g in last):
            rel = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
                      for g, w in zip(last, want_last))
            raise AssertionError(f"cluster: last-position logits not "
                                 f"bit-equal to the serve phase's (rel L2 "
                                 f"{rel:.3g})")
        server_pid = pid
        client.kill_actor(server)
        out["serve"] = {
            "model": MODEL_DESC["b1"], "requests": SERVE_REQUESTS,
            "inputs": list(SERVE_TOKENS), "actor_pid": server_pid,
            "node": "gpu", "startup_s": startup_s, "latency_s": latencies,
            "thread_tier_latency_s": report["serve"]["latency_s"],
            "reply": ("inline in the actor_call RPC reply; worker to "
                      "raylet over the pipe, its buffer in the raylet's "
                      "shm segment"),
            "reply_rpc_bytes": reply_bytes[-1] if reply_bytes else None,
            "kernel_launches": counts, "kernel_launches_by_route": routes,
            "last_logits_bitwise_equal_serve": bitwise}
        print(f"cluster: b1 actor in a worker of the GPU raylet (pid "
              f"{server_pid}) up (first forward included) in "
              f"{startup_s:.2f} s; {SERVE_REQUESTS} requests of "
              f"{list(SERVE_TOKENS)}, latency s "
              f"{[round(x, 4) for x in latencies]} (thread tier "
              f"{[round(x, 4) for x in report['serve']['latency_s']]}); "
              f"replies inline in the actor_call RPC, "
              f"{out['serve']['reply_rpc_bytes']} bytes; launches in the "
              f"actor {routes}; last-position logits bit-equal to the "
              f"serve phase's", flush=True)

        # one cross-node object
        array = np.random.default_rng(1).integers(
            0, 1 << 20, size=CROSS_NODE_BYTES // 8, dtype=np.int64)
        ref = client.put(array)
        reader = cpu_node if ref.node_id == gpu_node else gpu_node
        t = time.monotonic()
        total = client.get(client.submit(_array_sum, (ref,),
                                         node_id=reader), timeout=120.0)
        cross_s = time.monotonic() - t
        if total != int(array.sum()):
            raise AssertionError(f"cluster: cross-node sum {total} != "
                                 f"{int(array.sum())}")
        fetches = cluster.node_stats(reader).get("fetches")
        out["cross_node"] = {"bytes": array.nbytes, "seconds": cross_s,
                             "reader_fetches": fetches}
        print(f"cluster: {array.nbytes} B put on one node, summed by a task "
              f"on the other in {cross_s:.3f} s (reader's fetches "
              f"{fetches})", flush=True)
        started = _descendants([gcs_pid, *(p.pid for p in
                                           cluster.raylets.values())])
    finally:
        os.environ.pop(override, None)
        if client is not None:
            client.close()
        if cluster is not None:
            servers = [cluster.gcs_proc.pid,
                       *(p.pid for p in cluster.raylets.values())]
            started |= _descendants(servers)
            cluster.shutdown()
            out["killed_after_shutdown"] = _reap(started)
        out["segments_swept"] = sweep_stale_segments(min_age_s=0.0)
    report["cluster"] = out
    return routes


# ------------------------------------------------------------------ main


def _at_shapes(report: dict, kernel: str) -> dict:
    """The kernel's time, bound, plain and library times at the moe and
    vit train shapes and at the head dims off 64 and 128 (kernel phase
    rows)."""
    out = {}
    for name in ("moe", "vit", *HEAD_DIM_SHAPES):
        if kernel == "fwd":
            r = next(r for r in report["kernel_shapes"] if r["shape"] == name)
            out[name] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
        else:
            r = next(r for r in report["bwd_shapes"] if r["shape"] == name)
            out[name] = {"ms": r[f"{kernel}_ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r[f"{kernel}_bound_ms"],
                         "bound_by": r[f"{kernel}_bound_by"],
                         "library_ms": r["library_ms"]}
    return out


def _kernel_table(report: dict, paths: dict) -> list:
    """The kernels JSON line: each kernel at the b1 train shape, its
    launches per path and route, and its rows at the moe and vit
    shapes."""
    for path in ("moe", "vit"):  # serve and train launches of a model
        paths[path] = _merge_routes(paths.pop(f"{path}_serve"), paths[path])
    fwd = next(r for r in report["kernel_shapes"] if r["shape"] == "train")
    bwd = next(r for r in report["bwd_shapes"] if r["shape"] == "train")
    shape = "B8 S2048 H16 D128 causal bfloat16 (the b1 train step)"
    csrc = "ray_tpu_torch/ops/csrc/"

    def launches(kernel):
        by_path = {p: sum(r[kernel].values()) for p, r in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_by_route": {p: r[kernel]
                                      for p, r in paths.items()}}

    def head_dims(kernel):
        """{route: the head dims the kernel phase ran on it}."""
        rows = (report["kernel_shapes"] if kernel == "fwd"
                else report["bwd_shapes"])
        out = {}
        for r in rows:
            route = r["route"] if kernel == "fwd" else r["routes"][kernel]
            out.setdefault(route, set()).add(r["D"])
        return {route: sorted(ds) for route, ds in out.items()}

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": fwd["route"],
        "source": csrc + "flash_attn_fwd.cu",
        # the wgmma kernel and C entry, then the mma.sync and FMA routes
        "sources": [csrc + f for f in ("flash_attn_fwd.cu",
                                       "flash_attn_fwd_mma.cu",
                                       "flash_attn_fwd_fma.cu")],
        "replaces": "ray_tpu/ops/attention.py:202",
        **launches("fwd"), "head_dims_by_route": head_dims("fwd"),
        "max_abs_err": max(r["max_abs_err"]
                           for r in report["kernel_shapes"]),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"], "shape": shape,
        "at_shapes": _at_shapes(report, "fwd"),
    }]
    for name, kernel, line, errs in (
            ("flash_attention_bwd_dq", "dq", 356, ("dq",)),
            ("flash_attention_bwd_dkdv", "dkdv", 404, ("dk", "dv"))):
        kernels.append({
            "name": name, "route": "cuda",
            "kernel_route": bwd["routes"][kernel],
            "source": csrc + "flash_attn_bwd.cu",
            "sources": [csrc + f for f in (
                "flash_attn_bwd.cu", f"flash_attn_bwd_{kernel}_mma.cu",
                "flash_attn_bwd_fma.cu")],
            "replaces": f"ray_tpu/ops/attention.py:{line}",
            **launches(kernel), "head_dims_by_route": head_dims(kernel),
            "max_abs_err": max(r["max_abs_err"][e]
                               for r in report["bwd_shapes"] for e in errs),
            "ms": bwd[f"{kernel}_ms"],
            # the plain backward and SDPA's backward compute dq, dk and
            # dv in one call: the same time stands in both rows
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[f"{kernel}_bound_ms"],
            "bound_by": bwd[f"{kernel}_bound_by"],
            "library_ms": bwd["library_ms"], "shape": shape,
            "at_shapes": _at_shapes(report, kernel),
        })
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401 — a bare directory fails here

    report: dict = {"phase_s": {}}
    paths, failed = {}, []
    t_start = time.monotonic()
    for name, phase in (
            ("build", phase_build), ("kernel", phase_kernel),
            ("debug", phase_debug),
            ("sched", phase_sched), ("serve", phase_serve),
            ("proc_serve", phase_proc_serve),
            ("cluster", phase_cluster),
            ("train", phase_train),
            ("moe_serve", lambda r: phase_serve(r, "moe")),
            ("moe", phase_moe),
            ("vit_serve", lambda r: phase_serve(r, "vit")),
            ("vit", phase_vit)):
        t0 = time.monotonic()
        try:
            routes = phase(report)
        except Exception as exc:  # the later phases still run and report;
            # the script fails below, with no result line
            traceback.print_exc()
            failed.append(f"{name}: {exc!r}"[:500])
            continue
        finally:
            report["phase_s"][name] = time.monotonic() - t0
        if routes is not None:
            paths[name] = routes
    report["total_s"] = time.monotonic() - t_start
    print(f"phases s {({k: round(v, 1) for k, v in report['phase_s'].items()})}"
          f", total {report['total_s']:.1f}", flush=True)
    if failed:
        report["failed"] = failed
    else:
        report["kernels"] = _kernel_table(report, paths)
    report.pop("_serve_last_logits", None)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if failed:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failed),
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": report["kernels"]}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
