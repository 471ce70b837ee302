"""Distributed sort: sample → range partition → per-partition sort.

Reference: python/ray/data/impl/sort.py (sample boundaries, shuffle rows
into boundary-delimited partitions, sort each partition in parallel).
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Tuple, Union

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    BlockMetadata,
    build_output_block,
)

SAMPLES_PER_BLOCK = 10


def _key_fn(key: Union[str, Callable, None]) -> Callable:
    if key is None:
        return lambda r: r
    if callable(key):
        return key
    return lambda r: r[key]


def sort_blocks(block_refs: List["ray_tpu_torch.ObjectRef"],
                key: Union[str, Callable, None], descending: bool
                ) -> Tuple[List["ray_tpu_torch.ObjectRef"], List[BlockMetadata]]:
    if not block_refs:
        return [], []
    kf = _key_fn(key)
    num_out = len(block_refs)

    @ray_tpu_torch.remote
    def sample_block(block: Block):
        return BlockAccessor.for_block(block).sample(SAMPLES_PER_BLOCK, kf)

    samples = sorted(
        s for part in ray_tpu_torch.get(
            [sample_block.remote(r) for r in block_refs]) for s in part)
    if samples:
        step = max(len(samples) // num_out, 1)
        boundaries = [samples[i * step] for i in range(1, num_out)
                      if i * step < len(samples)]
    else:
        boundaries = []
    nparts = len(boundaries) + 1

    @ray_tpu_torch.remote(num_returns=max(nparts, 1))
    def partition_block(block: Block):
        acc = BlockAccessor.for_block(block)
        parts: List[list] = [[] for _ in range(nparts)]
        for r in acc.iter_rows():
            parts[bisect.bisect_left(boundaries, kf(r))].append(r)
        out = [build_output_block(p) for p in parts]
        return out if nparts > 1 else out[0]

    @ray_tpu_torch.remote(num_returns=2)
    def merge_sorted(*parts: Block):
        rows: list = []
        for p in parts:
            rows.extend(BlockAccessor.for_block(p).iter_rows())
        rows.sort(key=kf, reverse=descending)
        block = build_output_block(rows)
        return block, BlockAccessor.for_block(block).get_metadata()

    map_out = [partition_block.remote(r) for r in block_refs]
    if nparts == 1:
        map_out = [[m] for m in map_out]
    part_order = (range(nparts - 1, -1, -1) if descending
                  else range(nparts))
    out_refs, meta_refs = [], []
    for j in part_order:
        b, meta = merge_sorted.remote(*[m[j] for m in map_out])
        out_refs.append(b)
        meta_refs.append(meta)
    metas = ray_tpu_torch.get(meta_refs)
    return out_refs, metas
