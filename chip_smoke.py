#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path once and checks it, phase by phase; any
failure raises and the script exits non-zero. Phases:

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
              took;
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
  5. train  — a Cluster with one GPU node; ray_tpu_torch.train.Trainer
              with one GPU worker runs a train function that builds
              ModelConfig.b1 at full width and depth (random weights from
              a seed, remat "full") and takes 4 optimizer steps on one
              seeded [8, 2049] token batch. Losses must be finite and
              falling, K1 must launch 2 x 24 x 4 times (forward and remat
              recompute) and K2 and K3 24 x 4 times each, all three on
              the wgmma route, and one step's gradients must agree with
              the same step on the plain attention, leaf by leaf.

The line before the last is the card's name and power limit as
nvidia-smi prints them; above it, one JSON line with the kernel table
(``launches`` from the train phase, per path in ``launches_by_path``,
per route in ``launches_by_route``; ``kernel_route`` is the route at the
train shape).
The last line is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Without CUDA the script exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

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
]

SCHED = dict(nodes=256, tasks=100_000, classes=32)
SERVE_REQUESTS = 4
SERVE_TOKENS = (2, 2048)
TRAIN_STEPS = 4
TRAIN_TOKENS = (8, 2049)  # [B, S + 1]: next-token targets for S = 2048
# one step's gradients, kernels vs the plain attention, relative L2 per
# leaf: both run the same bf16 model; the kernels round p and ds to bf16
# inside attention (the plain version keeps fp32) and that difference
# flows back through 24 layers; a wrong kernel (mask, scale, transpose)
# moves the gradients by O(1)
GRAD_REL_L2_TOL = 5e-2


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
    for name, b, s, h, d, causal, dtype in KERNEL_SHAPES:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(len(rows))
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda")
                   .to(dt) for _ in range(3))
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
        bound_ms, bound_by = _attention_work("fwd", b, s, s, h, d, causal,
                                             dtype)
        route = attention.kernel_route("fwd", dt, d)
        row = {"shape": name, "B": b, "S": s, "H": h, "D": d,
               "causal": causal, "dtype": dtype, "route": route,
               "max_abs_err": err_out,
               "max_abs_err_lse": err_lse, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        rows.append(row)
        print(f"kernel: {name} B{b} S{s} H{h} D{d} causal={causal} "
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


class ModelServer:
    """Serves ModelConfig.b1 at full width and depth on the card."""

    def __init__(self, seed: int):
        import torch

        from ray_tpu_torch.models import transformer as tfm
        from ray_tpu_torch.models.training import build_forward
        from ray_tpu_torch.ops.attention import blockwise_attention

        self.cfg = tfm.ModelConfig.b1()
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

    def forward_plain(self, tokens):
        import torch

        logits = self.fwd_plain(self.params, tokens)
        torch.cuda.current_stream().synchronize()
        return logits


def phase_serve(report: dict) -> None:
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models.transformer import ModelConfig

    cfg = ModelConfig.b1()
    cluster = Cluster(head_node_args={
        "num_cpus": 4, "device": "cuda",
        # logits stay on the card; keep them out of the spill path
        "_system_config": {"object_store_memory": 64 << 30}})
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=4)
        cluster.add_node(num_cpus=4, num_gpus=1)
        server_cls = ray_tpu_torch.remote(num_gpus=1)(ModelServer)
        t0 = time.monotonic()
        server = server_cls.remote(0)
        rng = np.random.default_rng(0)
        batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
                   for _ in range(SERVE_REQUESTS)]
        # the first call includes construction (weights drawn on the card)
        ray_tpu_torch.get(server.forward.remote(batches[0][:, :16]))
        setup_s = time.monotonic() - t0
        _reset_counts()
        latencies, first = [], None
        for tokens in batches:
            t = time.monotonic()
            logits = ray_tpu_torch.get(server.forward.remote(tokens))
            latencies.append(time.monotonic() - t)
            if first is None:
                first = logits
            del logits
        counts = _read_counts()
        routes = _read_routes()
        launches = counts["fwd"]
        if launches != cfg.layers * SERVE_REQUESTS or counts["dq"] or \
                counts["dkdv"]:
            raise AssertionError(
                f"attention kernels launched {counts} for "
                f"{SERVE_REQUESTS} requests; expected {cfg.layers} "
                f"forward launches each and no backward")
        want_route = _main_path_routes("bfloat16", cfg.head_dim)["fwd"]
        if routes["fwd"] != {want_route: launches}:
            raise AssertionError(f"served forward launches by route "
                                 f"{routes['fwd']}; expected all on "
                                 f"{want_route}")
        plain = ray_tpu_torch.get(server.forward_plain.remote(batches[0]))
        if first.shape != (*SERVE_TOKENS, cfg.vocab_size) or \
                not torch.isfinite(first).all():
            raise AssertionError("served logits malformed or not finite")
        rel = ((first - plain).norm() / plain.norm()).item()
        max_abs = (first - plain).abs().max().item()
        agree = (first.argmax(-1) == plain.argmax(-1)).float().mean().item()
        if not rel <= SERVE_REL_L2_TOL:
            raise AssertionError(
                f"served logits off the plain-attention model: rel L2 "
                f"{rel:.3g} > {SERVE_REL_L2_TOL}")
        report["serve"] = {
            "model": "ModelConfig.b1 (hidden 2048, 24 layers, 16 heads, "
                     "d 128, inter 5632, vocab 32000, bf16)",
            "requests": SERVE_REQUESTS, "tokens": list(SERVE_TOKENS),
            "setup_s": setup_s, "latency_s": latencies,
            "kernel_launches": launches,
            "kernel_launches_by_route": routes["fwd"],
            "logits_rel_l2_vs_plain": rel,
            "logits_max_abs_vs_plain": max_abs,
            "argmax_agreement_vs_plain": agree,
            "logits_abs_max": first.abs().max().item(),
        }
        print(f"serve: b1 actor answered {SERVE_REQUESTS} requests of "
              f"{SERVE_TOKENS[0]}x{SERVE_TOKENS[1]} tokens, latency s "
              f"{[round(x, 4) for x in latencies]}; kernel launches "
              f"{routes['fwd']}; logits vs plain attention rel L2 {rel:.3g}, "
              f"argmax agreement {agree:.4f}", flush=True)
        del first, plain
    finally:
        cluster.shutdown()
    return routes["fwd"]


# --------------------------------------------------------------- phase 5


def _b1_train_batch():
    import numpy as np

    from ray_tpu_torch.models.transformer import ModelConfig

    rng = np.random.default_rng(0)
    return rng.integers(0, ModelConfig.b1().vocab_size, size=TRAIN_TOKENS)


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
    tokens = torch.as_tensor(_b1_train_batch(), device="cuda")
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


def _one_step_grads(attention_fn):
    """Gradients of b1's loss at its seeded initial weights on the train
    batch, with ``attention_fn`` (None: the kernels)."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import tree_leaves

    cfg = tfm.ModelConfig.b1()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.as_tensor(_b1_train_batch(), device="cuda").long()
    loss = tfm.loss_fn(params, tokens, cfg, attention_fn)
    grads = torch.autograd.grad(loss, leaves)
    names = [f"layers.{n}" if k == "layers" else k
             for k, v in params.items()
             for n in (v if k == "layers" else (None,))]
    return loss.item(), dict(zip(names, grads))


def phase_train(report: dict) -> dict:
    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models.transformer import ModelConfig
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = ModelConfig.b1()
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
        trainer.run(train_b1, callbacks=[Collect()])
        run_s = time.monotonic() - t0
        counts = _read_counts()
        routes = _read_routes()
        trainer.shutdown()
    finally:
        cluster.shutdown()
    want = {"fwd": 2 * cfg.layers * TRAIN_STEPS,
            "dq": cfg.layers * TRAIN_STEPS,
            "dkdv": cfg.layers * TRAIN_STEPS}
    if counts != want:
        raise AssertionError(
            f"attention kernels launched {counts} over {TRAIN_STEPS} "
            f"train steps; expected {want}")
    want_routes = _main_path_routes("bfloat16", cfg.head_dim)
    for kernel, route in want_routes.items():
        if routes[kernel] != {route: want[kernel]}:
            raise AssertionError(
                f"{kernel} launches by route {routes[kernel]} over the "
                f"train steps; expected all {want[kernel]} on {route}")
    losses = [r["loss"] for r in rows]
    if len(rows) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"b1 train losses not finite and falling: "
                             f"{losses}")

    loss_k, grads_k = _one_step_grads(None)
    loss_p, grads_p = _one_step_grads(blockwise_attention)
    rel = {name: ((grads_k[name].float() - grads_p[name].float()).norm()
                  / grads_p[name].float().norm()).item()
           for name in grads_k}
    worst = max(rel, key=rel.get)
    if not all(math.isfinite(r) for r in rel.values()) or \
            rel[worst] > GRAD_REL_L2_TOL:
        raise AssertionError(
            f"one step's gradients on the kernels off the plain attention:"
            f" {worst} rel L2 {rel[worst]:.3g} > {GRAD_REL_L2_TOL}")
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
        "model": "ModelConfig.b1 (hidden 2048, 24 layers, 16 heads, d 128, "
                 "inter 5632, vocab 32000, bf16, remat full)",
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
    return counts, routes


# ------------------------------------------------------------------ main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401 — a bare directory fails here

    report: dict = {}
    phase_build(report)
    phase_kernel(report)
    phase_sched(report)
    serve_routes = phase_serve(report)
    counts, routes = phase_train(report)
    fwd = next(r for r in report["kernel_shapes"] if r["shape"] == "train")
    bwd = next(r for r in report["bwd_shapes"] if r["shape"] == "train")
    shape = "B8 S2048 H16 D128 causal bfloat16 (the b1 train step)"
    csrc = "ray_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": fwd["route"],
        "source": csrc + "flash_attn_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:202",
        "launches": counts["fwd"],
        "launches_by_path": {"serve": sum(serve_routes.values()),
                             "train": counts["fwd"]},
        "launches_by_route": {"serve": serve_routes,
                              "train": routes["fwd"]},
        "max_abs_err": max(r["max_abs_err"]
                           for r in report["kernel_shapes"]),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"], "shape": shape,
    }]
    for name, kernel, line, errs in (
            ("flash_attention_bwd_dq", "dq", 356, ("dq",)),
            ("flash_attention_bwd_dkdv", "dkdv", 404, ("dk", "dv"))):
        kernels.append({
            "name": name, "route": "cuda",
            "kernel_route": bwd["routes"][kernel],
            "source": csrc + "flash_attn_bwd.cu",
            "replaces": f"ray_tpu/ops/attention.py:{line}",
            "launches": counts[kernel],
            "launches_by_path": {"serve": 0, "train": counts[kernel]},
            "launches_by_route": {"serve": {}, "train": routes[kernel]},
            "max_abs_err": max(r["max_abs_err"][e]
                               for r in report["bwd_shapes"] for e in errs),
            "ms": bwd[f"{kernel}_ms"],
            # the plain backward and SDPA's backward compute dq, dk and
            # dv in one call: the same time stands in both rows
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[f"{kernel}_bound_ms"],
            "bound_by": bwd[f"{kernel}_bound_by"],
            "library_ms": bwd["library_ms"], "shape": shape,
        })
    report["kernels"] = kernels
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
