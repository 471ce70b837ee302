"""Push-based two-stage shuffle (reference: python/ray/data/impl/shuffle.py).

Stage 1 (map): each input block is split into ``num_out`` sub-blocks by
hash (repartition) or uniform-random assignment (random_shuffle).
Stage 2 (reduce): each output block concatenates its sub-blocks from
every mapper and, for random_shuffle, permutes rows locally.

Both stages are stateless tasks, so the object store carries all
intermediate data — this path is the object-store stressor the reference
uses for its nightly shuffle benchmarks (release/nightly_tests/shuffle/).
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    BlockMetadata,
    build_output_block,
)


def shuffle_blocks(block_refs: List["ray_tpu_torch.ObjectRef"], num_out: int,
                   randomize: bool, seed: Optional[int] = None
                   ) -> Tuple[List["ray_tpu_torch.ObjectRef"],
                              List[BlockMetadata]]:
    if not block_refs:
        return [], []

    @ray_tpu_torch.remote(num_returns=num_out)
    def shuffle_map(block: Block, map_idx: int):
        acc = BlockAccessor.for_block(block)
        rows = list(acc.iter_rows())
        if randomize:
            rng = random.Random(None if seed is None else seed + map_idx)
            rng.shuffle(rows)
            parts = [rows[i::num_out] for i in range(num_out)]
        else:
            per = (len(rows) + num_out - 1) // max(num_out, 1)
            parts = [rows[i * per:(i + 1) * per] for i in range(num_out)]
        out = [build_output_block(p) for p in parts]
        return out if num_out > 1 else out[0]

    @ray_tpu_torch.remote(num_returns=2)
    def shuffle_reduce(reduce_idx: int, *parts: Block):
        rows: list = []
        for p in parts:
            rows.extend(BlockAccessor.for_block(p).iter_rows())
        if randomize:
            rng = random.Random(None if seed is None else seed * 31 +
                                reduce_idx)
            rng.shuffle(rows)
        block = build_output_block(rows)
        return block, BlockAccessor.for_block(block).get_metadata()

    map_out = [shuffle_map.remote(ref, i)
               for i, ref in enumerate(block_refs)]
    if num_out == 1:
        map_out = [[r] if not isinstance(r, list) else r for r in map_out]
    out_refs, meta_refs = [], []
    for j in range(num_out):
        parts = [m[j] for m in map_out]
        b, meta = shuffle_reduce.remote(j, *parts)
        out_refs.append(b)
        meta_refs.append(meta)
    metas = ray_tpu_torch.get(meta_refs)
    return out_refs, metas
