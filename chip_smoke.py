#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path once and checks it, phase by phase; any
failure raises and the script exits non-zero. Phases:

  1. build  — compile the port's CUDA kernels from ray_tpu_torch/ops/csrc
              and print the card's name and power limit;
  2. kernel — hold the flash-attention forward kernel against its plain
              torch version (``_blockwise_fwd``) on the card at the main
              path's shapes, and time kernel, plain version, the bound
              and one PyTorch library call (a yardstick only);
  3. sched  — drain 256 nodes x 100k tasks x 32 classes through the live
              raylet tick with the placement solve on CUDA: the
              single-buffered tick must place every task where the numpy
              path does, the pipelined tick must drain with the device
              mirror's drift check on;
  4. serve  — ray_tpu_torch.init(device="cuda") with a few nodes; an
              actor holds ModelConfig.b1 at full width and depth (random
              weights from a seed) and answers forward.remote(tokens)
              requests; the kernel's launch count over those requests
              must be 24 per request, and one request's logits must
              agree with the same model on the plain attention.

The line before the last is the card's name and power limit as
nvidia-smi prints them; above it, one JSON line with the kernel table.
The last line is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Without CUDA the script exits 2 and
prints no result.
"""

from __future__ import annotations

import json
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
# served logits, kernel vs plain attention, relative L2: the two
# attentions round differently at bf16's 2^-9 relative step, and 24
# residual layers compound that; a wrong kernel (mask, scale, row)
# moves the logits by O(1)
SERVE_REL_L2_TOL = 3e-2

KERNEL_SHAPES = [
    # name, B, S, H, D, causal, dtype — b1's shape, entry()'s shape after
    # the GQA repeat, and a ragged fp32 one
    ("b1", 2, 2048, 16, 128, True, "bfloat16"),
    ("entry", 2, 128, 8, 32, True, "bfloat16"),
    ("ragged", 1, 1000, 4, 64, False, "float32"),
]

SCHED = dict(nodes=256, tasks=100_000, classes=32)
SERVE_REQUESTS = 4
SERVE_TOKENS = (2, 2048)


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


def phase_build(report: dict) -> None:
    from ray_tpu_torch.ops import attention

    t0 = time.monotonic()
    log = attention.build_kernels()
    report["build_s"] = time.monotonic() - t0
    report["ptxas"] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    report["card"] = card_line()
    print(f"build: kernels built in {report['build_s']:.1f} s on "
          f"{report['card']}", flush=True)


# --------------------------------------------------------------- phase 2


def _attention_work(b, s, h, d, causal, dtype):
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4  # q,k,v,out + lse
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
        out, lse = attention.flash_attention(q, k, v, causal)
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
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, causal), 20)
        plain_ms = cuda_ms(
            lambda: attention._blockwise_fwd(q, k, v, causal, scale), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 20)
        bound_ms, bound_by = _attention_work(b, s, h, d, causal, dtype)
        row = {"shape": name, "B": b, "S": s, "H": h, "D": d,
               "causal": causal, "dtype": dtype, "max_abs_err": err_out,
               "max_abs_err_lse": err_lse, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        rows.append(row)
        print(f"kernel: {name} B{b} S{s} H{h} D{d} causal={causal} "
              f"{dtype}: err out {err_out:.3g} lse {err_lse:.3g}; "
              f"ms {ms:.4f} plain {plain_ms:.4f} bound {bound_ms:.4f} "
              f"({bound_by}) sdpa {library_ms:.4f}", flush=True)
        del q, k, v, out, lse, p_out, p_lse
    report["kernel_shapes"] = rows


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
        from ray_tpu_torch.ops.attention import _blockwise_fwd

        self.cfg = tfm.ModelConfig.b1()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.params = tfm.init_params(self.cfg, gen, device="cuda")
        self.fwd = build_forward(self.cfg, device="cuda")
        self.fwd_plain = build_forward(
            self.cfg, device="cuda",
            attention_fn=lambda q, k, v: _blockwise_fwd(
                q, k, v, True, q.shape[-1] ** -0.5)[0])

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
    from ray_tpu_torch.ops import attention

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
        attention.launches.reset()
        latencies, first = [], None
        for tokens in batches:
            t = time.monotonic()
            logits = ray_tpu_torch.get(server.forward.remote(tokens))
            latencies.append(time.monotonic() - t)
            if first is None:
                first = logits
            del logits
        launches = attention.launches.count
        if launches != cfg.layers * SERVE_REQUESTS:
            raise AssertionError(
                f"attention kernel launched {launches} times for "
                f"{SERVE_REQUESTS} requests; expected {cfg.layers} each")
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
            "kernel_launches": launches, "logits_rel_l2_vs_plain": rel,
            "logits_max_abs_vs_plain": max_abs,
            "argmax_agreement_vs_plain": agree,
            "logits_abs_max": first.abs().max().item(),
        }
        print(f"serve: b1 actor answered {SERVE_REQUESTS} requests of "
              f"{SERVE_TOKENS[0]}x{SERVE_TOKENS[1]} tokens, latency s "
              f"{[round(x, 4) for x in latencies]}; kernel launches "
              f"{launches}; logits vs plain attention rel L2 {rel:.3g}, "
              f"argmax agreement {agree:.4f}", flush=True)
        del first, plain
    finally:
        cluster.shutdown()
    return launches


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
    launches = phase_serve(report)
    b1 = report["kernel_shapes"][0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:202",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"]
                           for r in report["kernel_shapes"]),
        "ms": b1["ms"], "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
        "library_ms": b1["library_ms"],
        "shape": "B2 S2048 H16 D128 causal bfloat16",
    }]
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
