"""Compute strategies: stateless tasks vs an autoscaling actor pool.

Reference: python/ray/data/impl/compute.py (TaskPool vs ActorPool). The
actor pool exists for stateful/expensive-setup UDFs (e.g. a model reused
across batches); tasks are the default.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata


def _apply_fn(fn: Callable, block: Block) -> Tuple[Block, BlockMetadata]:
    out = fn(block)
    meta = BlockAccessor.for_block(out).get_metadata()
    try:  # record WHERE the block materialized, for locality-aware split
        import ray_tpu_torch

        meta.node_id = ray_tpu_torch.get_runtime_context().get_node_id()
    except Exception:
        pass
    return out, meta


class ComputeStrategy:
    def apply(self, fn: Callable[[Block], Block], remote_args: dict,
              block_refs: List["ray_tpu_torch.ObjectRef"]
              ) -> Tuple[List["ray_tpu_torch.ObjectRef"], List[BlockMetadata]]:
        raise NotImplementedError


class TaskPoolStrategy(ComputeStrategy):
    def apply(self, fn, remote_args, block_refs):
        remote_args = dict(remote_args or {})
        remote_args.setdefault("num_cpus", 0.25)

        @ray_tpu_torch.remote(**remote_args, num_returns=2)
        def _map_block(block):
            return _apply_fn(fn, block)

        out_refs, meta_refs = [], []
        for ref in block_refs:
            b, m = _map_block.remote(ref)
            out_refs.append(b)
            meta_refs.append(m)
        metas = ray_tpu_torch.get(meta_refs)
        return out_refs, metas


class ActorPoolStrategy(ComputeStrategy):
    """Fixed-size (min_size..max_size) pool of worker actors; each holds
    the instantiated UDF (reference: data/impl/compute.py:ActorPool)."""

    def __init__(self, min_size: int = 1, max_size: Optional[int] = None):
        self.min_size = min_size
        self.max_size = max_size or min_size

    def apply(self, fn, remote_args, block_refs):
        remote_args = dict(remote_args or {})
        remote_args.setdefault("num_cpus", 0.25)

        @ray_tpu_torch.remote(**remote_args)
        class _BlockWorker:
            def map_block(self, block):
                return _apply_fn(fn, block)

        n = max(self.min_size, min(self.max_size, len(block_refs)))
        workers = [_BlockWorker.remote() for _ in range(n)]
        from ray_tpu_torch.util.actor_pool import ActorPool

        pool = ActorPool(workers)
        results = list(pool.map(
            lambda a, ref: a.map_block.remote(ref), block_refs))
        for w in workers:
            ray_tpu_torch.kill(w)
        out_refs = [ray_tpu_torch.put(b) for b, _ in results]
        metas = [m for _, m in results]
        return out_refs, metas


def get_compute(compute: Any) -> ComputeStrategy:
    if compute is None or compute == "tasks":
        return TaskPoolStrategy()
    if compute == "actors":
        return ActorPoolStrategy()
    if isinstance(compute, ComputeStrategy):
        return compute
    raise ValueError(f"unknown compute strategy: {compute!r}")
