"""The multichip dry run: one train step under every parallelism kind the
port ships, on n ranks -- the counterpart of the JAX package's
entry points ``entry()`` and ``dryrun_multichip(n)``.

    python3 -m ray_tpu_torch.tools.multichip N [--device cuda|cpu]
                                               [--backend nccl|gloo]

``entry(device="cuda")`` -> ``(fwd, (params, tokens))``: the flagship
forward at the JAX entry's config (vocab 2048, hidden 256, 4 layers, 8
heads over 4 kv heads, bf16) with seeded weights and [2, 128] tokens on
the device.

``dryrun_multichip(n, device="cuda", backend=None)`` runs the JAX dry
run's steps with its configs and mesh shapes on a
``parallel.multihost.RankPool`` of n ranks:

  1. gspmd     the dp x sp x tp step of ``MeshSpec.auto(n, want_pp=False)``
               with MoE (``num_experts = max(2, dp)``, experts over dp,
               ring attention over sp);
  2. fsdp      the dense config's step at that mesh with ``fsdp=True``;
  3. pipeline  the dense config at pp 2 x tp (tp 2 where the rest of the
               ranks divide by 2) x dp, 2 microbatches;
  4. train     the train runtime: ``Trainer(num_workers=2)`` on the thread
               tier (its default ``TopologyConfig``), the workers meeting
               in a store collective group (an allreduce and a barrier),
               rank 0 driving step 1's mesh step through the pool.

The backend is NCCL with one rank a card on CUDA, gloo on the CPU; a
caller who wants gloo ranks sharing card 0 names ``backend="gloo"``.
Each step prints one line (its loss and seconds, the slowest rank's);
the function returns the rows. Weights are drawn from fixed seeds, and
``rank_step`` also takes the JAX package's weights (numpy, JAX layout)
and tokens, as the tests hand it.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Any, Dict, List, Optional

# the JAX dry run's model (every step; step 1 adds the experts)
DRYRUN_MODEL = dict(vocab_size=128, hidden=64, layers=2, heads=4,
                    kv_heads=4, intermediate=128, max_seq=64, remat=False)
DRYRUN_SEQ = 33  # [B, S + 1] tokens: next-token targets for S = 32
RANK_TIMEOUT_S = 600
# the JAX entry point's model (its remaining field: dtype bfloat16)
ENTRY_MODEL = dict(vocab_size=2048, hidden=256, layers=4, heads=8,
                   kv_heads=4, intermediate=704, max_seq=512, remat=False)


def entry(device="cuda"):
    """(fwd, (params, tokens)): ``build_forward`` of the JAX entry's
    config, weights seeded with 0 and zero tokens [2, 128] on ``device``
    (CUDA unless the caller asks for the CPU)."""
    import torch

    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_forward

    device = resolve_device(device)
    cfg = tfm.ModelConfig(**ENTRY_MODEL, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    tokens = torch.zeros((2, 128), dtype=torch.int64, device=device)
    return build_forward(cfg, device=device), (params, tokens)


def dryrun_plan(n: int) -> List[Dict[str, Any]]:
    """The mesh steps of the dry run on n ranks, as the JAX dry run lays
    them out: each a name, its MeshSpec axis sizes, model config fields,
    whether FSDP or the pipeline, the batch, and the seeds of its
    weights and tokens."""
    from ray_tpu_torch.parallel.mesh import MeshSpec

    spec = MeshSpec.auto(n, want_pp=False)
    axes = dict(dp=spec.dp, sp=spec.sp, tp=spec.tp)
    batch = max(2, 2 * spec.dp)
    plan = [
        dict(name="gspmd", axes=axes, fsdp=False, pipeline=False,
             model=dict(DRYRUN_MODEL, num_experts=max(2, spec.dp)),
             batch=batch, init_seed=0, token_seed=1),
        dict(name="fsdp", axes=axes, fsdp=True, pipeline=False,
             model=dict(DRYRUN_MODEL), batch=batch, init_seed=4,
             token_seed=1),
    ]
    if n >= 2:
        rest = n // 2
        tp = 2 if rest % 2 == 0 and rest >= 2 else 1
        plan.append(dict(name="pipeline",
                         axes=dict(dp=rest // tp, pp=2, tp=tp), fsdp=False,
                         pipeline=True, model=dict(DRYRUN_MODEL),
                         batch=max(2, 2 * (rest // tp)), init_seed=2,
                         token_seed=3))
    return plan


def _mesh_text(axes: Dict[str, int]) -> str:
    return " x ".join(f"{k}{v}" for k, v in axes.items() if v > 1) or "1"


def step_tokens(plan_step: Dict[str, Any]):
    """The step's seeded tokens [batch, DRYRUN_SEQ] (int64, CPU)."""
    import torch

    gen = torch.Generator().manual_seed(plan_step["token_seed"])
    return torch.randint(0, plan_step["model"]["vocab_size"],
                         (plan_step["batch"], DRYRUN_SEQ), generator=gen)


def rank_step(plan_step: Dict[str, Any], device: str, params_np=None,
              tokens=None) -> Dict[str, Any]:
    """One rank's share of one mesh step of ``dryrun_plan``: the weights
    from the step's seed (or ``params_np``, the JAX package's tree of
    numpy arrays, cut to this rank's shards), its tokens (or ``tokens``),
    one optimizer step -> loss, grad norm, seconds, bytes staged through
    host memory, this rank's card."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.collective import api as coll
    from ray_tpu_torch.models.convert import local_params, params_from_jax
    from ray_tpu_torch.models.training import (
        build_pipeline_train_step,
        build_train_step,
        make_optimizer,
        param_shardings,
    )
    from ray_tpu_torch.models.transformer import ModelConfig
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.multihost import sync_global_devices

    cfg = ModelConfig(**plan_step["model"], dtype=torch.float32)
    mesh = build_mesh(MeshSpec(**plan_step["axes"]), device_type=device)
    opt = make_optimizer()
    if plan_step["pipeline"]:
        step, init_fn = build_pipeline_train_step(
            cfg, mesh, num_microbatches=2, optimizer=opt)
    else:
        step, init_fn = build_train_step(cfg, mesh=mesh,
                                         fsdp=plan_step["fsdp"],
                                         optimizer=opt, sp_strategy="ring")
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    if params_np is None:
        params, opt_state = init_fn(torch.Generator(device=dev).manual_seed(
            plan_step["init_seed"]))
    else:
        params = local_params(params_from_jax(params_np, cfg, device=dev),
                              param_shardings(cfg, mesh, plan_step["fsdp"]),
                              mesh)
        opt_state = opt.init(params)
    tokens = step_tokens(plan_step) if tokens is None else tokens
    tokens = torch.as_tensor(tokens, device=dev).long()
    coll.staged_bytes.reset()
    sync_global_devices(plan_step["name"])
    t0 = time.monotonic()
    _, _, metrics = step(params, opt_state, tokens)
    loss = metrics["loss"].item()  # waits for the step
    seconds = time.monotonic() - t0
    card = None
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        card = f"cuda:{dev.index} {getattr(props, 'uuid', '')}"
    return {"rank": dist.get_rank(), "loss": loss,
            "grad_norm": metrics["grad_norm"].item(), "seconds": seconds,
            "staged_bytes": coll.staged_bytes.count, "card": card}


def _row(plan_step: Dict[str, Any], results: List[dict],
         backend: str) -> Dict[str, Any]:
    row = {"step": plan_step["name"], "mesh": _mesh_text(plan_step["axes"]),
           "backend": backend, "loss": results[0]["loss"],
           "grad_norm": results[0]["grad_norm"],
           "seconds": max(r["seconds"] for r in results),
           "staged_bytes_by_rank": [r["staged_bytes"] for r in results],
           "cards": [r["card"] for r in results]}
    if not math.isfinite(row["loss"]):
        raise RuntimeError(f"dry run step {row['step']}: loss {row['loss']}")
    print(f"dryrun {row['step']}: {row['mesh']} on {len(results)} "
          f"{backend} ranks: loss {row['loss']:.6f} in "
          f"{row['seconds']:.3f} s", flush=True)
    return row


def _train_runtime(pool, plan_step: Dict[str, Any], device: str,
                   backend: str) -> Dict[str, Any]:
    """Step 4: ``Trainer(num_workers=2)`` on the thread tier; its workers
    meet in a store collective group (allreduce, barrier) and rank 0
    drives ``plan_step``'s mesh step through ``pool``."""
    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.collective.api import (
        destroy_collective_group,
        init_collective_group,
    )

    group_name = "dryrun-train"
    mesh_rows: List[dict] = []

    def train_func():
        import numpy as np

        rank, world = train.world_rank(), train.world_size()
        group = init_collective_group(world, rank, group_name)
        total = group.allreduce(np.array([float(rank + 1)]))
        group.barrier()
        loss = 0.0
        if rank == 0:
            results = pool.run(rank_step, plan_step, device)
            mesh_rows.append(_row(plan_step, results, backend))
            loss = results[0]["loss"]
        train.report(loss=loss, allreduce_total=float(total[0]))
        return loss, float(total[0])

    started = not ray_tpu_torch.is_initialized()
    if started:
        ray_tpu_torch.init(num_cpus=4, device=device)
    t0 = time.monotonic()
    try:
        trainer = train.Trainer(num_workers=2)
        trainer.start()
        results = trainer.run(train_func)
        trainer.shutdown()
    finally:
        destroy_collective_group(group_name)
        if started:
            ray_tpu_torch.shutdown()
    seconds = time.monotonic() - t0
    losses = [loss for loss, _ in results if loss]
    # the allreduce of rank + 1 over the two workers
    if len(results) != 2 or any(total != 3.0 for _, total in results) \
            or len(losses) != 1 or not mesh_rows \
            or not math.isfinite(losses[0]):
        raise RuntimeError(f"dry run train runtime: worker results "
                           f"{results}")
    print(f"dryrun train: Trainer(num_workers=2), store group allreduce "
          f"and barrier, rank 0 drove {plan_step['name']}: loss "
          f"{losses[0]:.6f} in {seconds:.3f} s", flush=True)
    return {"step": "train", "loss": losses[0], "seconds": seconds,
            "mesh": mesh_rows[0]["mesh"], "backend": backend}


def dryrun_multichip(n: int, *, device="cuda", backend: Optional[str] = None
                     ) -> List[Dict[str, Any]]:
    """The four steps of the dry run on a RankPool of ``n`` ranks ->
    one row each (step, mesh, loss, seconds, ...). NCCL takes one card a
    rank and raises before any rank starts when fewer are visible."""
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.parallel.multihost import RankPool

    device = resolve_device(device).type
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        cuda_device = "per_rank" if backend == "nccl" else 0
    else:
        cuda_device = None
    pool = RankPool(n, backend=backend, cuda_device=cuda_device,
                    env={"RAY_TPU_collective_op_timeout_s":
                         str(RANK_TIMEOUT_S)},
                    timeout_s=RANK_TIMEOUT_S)
    plan = dryrun_plan(n)
    rows = []
    try:
        t0 = time.monotonic()
        pool.start()
        print(f"dryrun: {n} {backend} ranks on {device} started in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        for plan_step in plan:
            rows.append(_row(plan_step, pool.run(rank_step, plan_step,
                                                 device), backend))
        rows.append(_train_runtime(pool, plan[0], device, backend))
    finally:
        pool.close()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="one train step under every parallelism kind on N "
                    "ranks")
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None,
                        choices=(None, "nccl", "gloo"))
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device=args.device, backend=args.backend)
    print(f"dryrun_multichip({args.n}) ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
