"""Ulysses-style sequence parallelism: all-to-all head/sequence swap.

Port of ``ray_tpu/parallel/ulysses.py``. The second of the two
long-context strategies (with parallel/ring_attention.py). Ring attention
keeps sequence shards fixed and rotates K/V blocks around the ring — O(1)
memory overhead. Ulysses (DeepSpeed-Ulysses, arXiv:2309.14509) instead
swaps the sharding: an all-to-all re-shards [batch, seq/N, heads, dim]
into [batch, seq, heads/N, dim], runs flash attention on full sequences
for a head subset (on CUDA tensors the hand-written kernels: K1 forward,
K2/K3 backward), and swaps back. Two all-to-alls per attention call, but
the attention itself is local — the better trade when heads >> ranks.

Use inside ``parallel.shard_map(mesh)`` over the sequence axis, like
ring_attention:

    with shard_map(mesh):
        out = ulysses_attention(q, k, v, axis_name="sp")
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.collective.api import ici
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.parallel.mesh import axis_size


def _heads_to_seq(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """[b, s/N, h, d] -> [b, s, h/N, d]: split heads across the axis,
    gather the sequence. One all-to-all."""
    return ici.alltoall(x, axis_name, split_axis=2, concat_axis=1)


def _seq_to_heads(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """[b, s, h/N, d] -> [b, s/N, h, d]: the inverse swap."""
    return ici.alltoall(x, axis_name, split_axis=1, concat_axis=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str, causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over sequence-sharded q/k/v ([batch, seq_local, heads,
    head_dim], same layout as ring_attention). The heads this rank holds
    (heads / tp under tensor parallelism) must divide by the axis
    size."""
    sp = axis_size(axis_name)
    heads = q.shape[2]
    if heads % sp != 0:
        raise ValueError(
            f"ulysses needs this rank's heads ({heads}) divisible by the "
            f"sequence-parallel axis size ({sp})")
    q_h = _heads_to_seq(q, axis_name)
    k_h = _heads_to_seq(k, axis_name)
    v_h = _heads_to_seq(v, axis_name)
    out = flash_attention(q_h, k_h, v_h, causal=causal, sm_scale=sm_scale)
    return _seq_to_heads(out, axis_name)
