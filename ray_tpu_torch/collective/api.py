"""Collective communication API.

Port of ``ray_tpu/collective/api.py``, mirroring the reference's
ray.util.collective surface (util/collective/collective.py:
allreduce:253, broadcast:368, allgather:418, reducescatter:467,
send:526, recv:589, barrier) with two backends:

  - "ici": inside an SPMD region (``parallel.shard_map(mesh)``), ops run
    over the process group of the named mesh dimension
    (``mesh.get_group(axis)``): NCCL on CUDA tensors, gloo on the CPU.
    ``ring_shift`` and ``alltoall`` are differentiable, their backward
    the inverse shift or swap (the transposes of ``ppermute`` and
    ``all_to_all`` in the JAX package); every other op's backward is its
    transpose under one rule: the objective a rank differentiates is its
    share of a sum over ranks, so ``allreduce(sum)``'s backward is an
    all-reduce (models/training.py scales a replicated loss by the ranks
    that compute it). With a gloo group and a CUDA tensor the op stages
    the tensor through pinned host memory and back, counting the bytes
    in ``staged_bytes``: gloo takes no CUDA tensor for send/recv,
    all-to-all or all-gather. That is how a caller who names gloo runs
    several ranks on one card (``parallel/multihost.py``).
  - "store": between actors/processes holding host arrays, a rendezvous
    through the object store + a named synchronization actor — the moral
    equivalent of the reference's Gloo/Redis-store backend
    (gloo_collective_group.py), used off the SPMD hot path.

Group bootstrap maps to the reference's named-actor NCCLUniqueID exchange
(nccl_collective_group.py Rendezvous:28): the "store" backend rendezvouses
through a named coordinator actor exactly the same way.

``torch`` is imported by the ici ops, not with the module: a train
worker that only joins a store group does not load it.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

# --------------------------------------------------------------------------
# ICI backend: axis-name-based collectives over the bound mesh.
# --------------------------------------------------------------------------


class ByteCount:
    """Bytes an op staged through host memory (device to host plus host
    to device), counted where it copies."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self, n: int) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


staged_bytes = ByteCount()


def _group(axis: str):
    """(process group, size, this rank's index) of mesh axis ``axis``."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import current_mesh

    group = current_mesh().get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _run(x, group, op: Callable, inplace: bool = False):
    """``op(tensor) -> tensor``, the communication alone, on ``x`` made
    contiguous (a copy when ``op`` writes its input in place), staged
    through pinned host memory when the group is gloo and ``x`` is on
    CUDA; the result comes back on ``x``'s device. Layout work stays on
    ``x``'s device, outside ``op``."""
    import torch
    import torch.distributed as dist

    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        out = op(host)
        staged_bytes.add(host.nbytes + out.nbytes)
        return out.to(x.device)
    x = x.contiguous()
    return op(x.clone() if inplace else x)


def _all_reduce(x, group, op: str = "sum"):
    import torch.distributed as dist

    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                 "min": dist.ReduceOp.MIN}[op]

    def run(t):
        dist.all_reduce(t, reduce_op, group=group)
        return t

    return _run(x, group, run, inplace=True)


def _all_gather(x, group, n: int, dim: Optional[int]):
    """Every rank's ``x`` in rank order: stacked on a new leading axis
    (``dim`` None) or concatenated along ``dim``."""
    import torch
    import torch.distributed as dist

    def run(t):
        out = t.new_empty((n, *t.shape))
        if dist.get_backend(group) == "nccl":
            # one contiguous output, no per-rank views to fill
            dist.all_gather_into_tensor(out, t, group=group)
        else:
            dist.all_gather(list(out.unbind(0)), t, group=group)
        return out

    out = _run(x, group, run)
    return out if dim is None else torch.cat(out.unbind(0), dim)


def _shift(x, group, n: int, shift: int):
    """Send ``x`` to the rank ``shift`` ahead on the ring, receive from
    the one ``shift`` behind."""
    import torch
    import torch.distributed as dist

    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)

    def run(t):
        out = torch.empty_like(t)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, dst, group),
                dist.P2POp(dist.irecv, out, src, group)]):
            req.wait()
        return out

    return _run(x, group, run)


def _all_to_all(x, group, n: int, split_axis: int, concat_axis: int):
    """Tiled all-to-all: chunk j of ``split_axis`` goes to rank j, and the
    chunks received from ranks 0..n-1 concatenate along
    ``concat_axis``."""
    import torch
    import torch.distributed as dist

    def run(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    if x.shape[split_axis] % n:
        raise ValueError(f"all-to-all splits axis {split_axis} of size "
                         f"{x.shape[split_axis]} over {n} ranks")
    # chunk j of the split axis leads, so the exchange is one flat
    # all-to-all of equal slices
    chunks = x.movedim(split_axis, 0)
    chunks = chunks.reshape(n, chunks.shape[0] // n, *chunks.shape[1:])
    out = _run(chunks, group, run)
    return torch.cat([c.movedim(0, split_axis) for c in out.unbind(0)],
                     concat_axis).contiguous()


@functools.lru_cache(maxsize=None)
def _collective_fn():
    """The autograd Function every differentiable op applies: ``fwd`` on
    the input, ``bwd`` on the output's cotangent."""
    import torch

    class Collective(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, fwd, bwd):
            ctx.bwd = bwd
            return fwd(x)

        @staticmethod
        def backward(ctx, g):
            return ctx.bwd(g), None, None

    return Collective


def _apply(x, fwd: Callable, bwd: Callable):
    return _collective_fn().apply(x, fwd, bwd)


class ici:
    """Collectives over the mesh bound by ``parallel.shard_map`` — the
    JAX package's ICI collectives under shard_map, by axis name."""

    @staticmethod
    def allreduce(x, axis: Union[str, Sequence[str]] = "dp",
                  op: str = "sum"):
        """Reduce over ``axis`` (or over each axis of a tuple in turn).
        sum and mean are differentiable; max and min are not."""
        if not isinstance(axis, str):
            for a in axis:
                x = ici.allreduce(x, a, op)
            return x
        group, n, _ = _group(axis)
        if op in ("sum", "mean"):
            scale = 1.0 if op == "sum" else 1.0 / n

            def reduce(t):
                out = _all_reduce(t, group)
                return out if scale == 1.0 else out * scale

            return _apply(x, reduce, reduce)
        if op in ("max", "min"):
            return _all_reduce(x.detach(), group, op)
        raise ValueError(f"unsupported reduce op {op!r}")

    @staticmethod
    def allgather(x, axis: str = "dp", *, tiled: bool = False):
        """Every rank's ``x``: stacked on a new leading axis, or
        concatenated along axis 0 when ``tiled``. Backward: the
        cotangent summed over ranks, this rank's slice of it."""
        group, n, me = _group(axis)
        dim = 0 if tiled else None

        def bwd(g):
            g = _all_reduce(g, group)
            return g.chunk(n, 0)[me] if tiled else g[me]

        return _apply(x, lambda t: _all_gather(t, group, n, dim), bwd)

    @staticmethod
    def reducescatter(x, axis: str = "dp", *, scatter_dimension: int = 0):
        """The sum over ranks, this rank's chunk of ``scatter_dimension``
        (tiled). Backward: the cotangents gathered along it."""
        group, n, me = _group(axis)
        if x.shape[scatter_dimension] % n:
            raise ValueError(f"reducescatter splits axis "
                             f"{scatter_dimension} of size "
                             f"{x.shape[scatter_dimension]} over {n} ranks")

        def fwd(t):
            return _all_reduce(t, group).chunk(
                n, scatter_dimension)[me].contiguous()

        return _apply(x, fwd, lambda g: _all_gather(
            g, group, n, scatter_dimension))

    @staticmethod
    def broadcast(x, axis: str = "dp", root: int = 0):
        """Rank ``root``'s ``x`` on every rank. Backward: the cotangent
        summed over ranks, on ``root`` (zeros elsewhere)."""
        group, n, me = _group(axis)

        def fwd(t):
            return _all_gather(t, group, n, None)[root]

        def bwd(g):
            g = _all_reduce(g, group)
            return g if me == root else g.zero_()

        return _apply(x, fwd, bwd)

    @staticmethod
    def ring_shift(x, axis: str, shift: int = 1):
        """ppermute to the next neighbor on the ring — the primitive under
        ring attention and pipeline transfer. Backward: the shift back."""
        group, n, _ = _group(axis)
        return _apply(x, lambda t: _shift(t, group, n, shift),
                      lambda g: _shift(g, group, n, -shift))

    @staticmethod
    def alltoall(x, axis: str, split_axis: int, concat_axis: int):
        """Tiled all-to-all over ``axis``. Backward: the inverse swap."""
        group, n, _ = _group(axis)
        return _apply(
            x, lambda t: _all_to_all(t, group, n, split_axis, concat_axis),
            lambda g: _all_to_all(g, group, n, concat_axis, split_axis))

    @staticmethod
    def axis_index(axis: str) -> int:
        from ray_tpu_torch.parallel.mesh import axis_index

        return axis_index(axis)


# --------------------------------------------------------------------------
# Store backend: CPU-tensor collectives across actors via the object store.
# --------------------------------------------------------------------------


def _coordinator_cls():
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=0)
    class CollectiveCoordinator:
        """Named rendezvous + blackboard, one per group
        (reference: Rendezvous via named actor store,
        nccl_collective_group.py:43-100)."""

        def __init__(self, world_size: int):
            self.world_size = world_size
            self.boards: Dict[tuple, dict] = {}
            self.reads: Dict[tuple, set] = {}

        def post(self, op_id: tuple, rank: int, ref_holder: list):
            board = self.boards.setdefault(op_id, {})
            board[rank] = ref_holder[0]
            return len(board)

        def collect(self, op_id: tuple, rank: int, expected: int = -1):
            """Returns all refs once `expected` ranks have posted. The
            board is garbage-collected only after every expected rank has
            *collected* — an eager clear by the first reader would strand
            slower ranks on an empty board forever."""
            expected = self.world_size if expected < 0 else expected
            board = self.boards.get(op_id)
            if board is None or len(board) < expected:
                return None
            refs = [board[r] for r in sorted(board)]
            reads = self.reads.setdefault(op_id, set())
            reads.add(rank)
            if len(reads) >= expected:
                self.boards.pop(op_id, None)
                self.reads.pop(op_id, None)
            return refs

    return CollectiveCoordinator


_groups: Dict[str, "CollectiveGroup"] = {}
_groups_lock = threading.Lock()


class CollectiveGroup:
    def __init__(self, name: str, world_size: int, rank: int, coordinator):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.coordinator = coordinator
        self._op_counter = 0

    def _next_op(self, kind: str) -> tuple:
        self._op_counter += 1
        return (self.name, kind, self._op_counter)

    def _exchange(self, kind: str, value) -> List[Any]:
        """Post local value, busy-wait for all ranks, return all values.

        Bounded: a peer that died before posting (e.g. its train
        function raised) must surface as an error here, not leave this
        rank polling forever (collective_op_timeout_s; the reference's
        NCCL ops have the same watchdog shape)."""
        import time

        import ray_tpu_torch
        from ray_tpu_torch._private.config import Config

        op_id = self._next_op(kind)
        ref = ray_tpu_torch.put(value)
        ray_tpu_torch.get(
            self.coordinator.post.remote(op_id, self.rank, [ref]))
        timeout_s = Config.instance().collective_op_timeout_s
        deadline = time.monotonic() + timeout_s
        while True:
            refs = ray_tpu_torch.get(
                self.coordinator.collect.remote(op_id, self.rank))
            if refs is not None:
                return ray_tpu_torch.get(list(refs))
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective {kind} op {op_id} on rank {self.rank} "
                    f"timed out after {timeout_s:.0f}s waiting for "
                    f"{self.world_size} rank(s) to post — a peer died "
                    "before reaching this op, or is initializing slower "
                    "than collective_op_timeout_s allows")
            time.sleep(0.001)

    # -- ops ---------------------------------------------------------------
    def allreduce(self, array, op: str = "sum"):
        values = self._exchange("allreduce", np.asarray(array))
        stacked = np.stack(values)
        if op == "sum":
            return stacked.sum(axis=0)
        if op == "mean":
            return stacked.mean(axis=0)
        if op == "max":
            return stacked.max(axis=0)
        if op == "min":
            return stacked.min(axis=0)
        raise ValueError(f"unsupported reduce op {op!r}")

    def allgather(self, array) -> List[np.ndarray]:
        return self._exchange("allgather", np.asarray(array))

    def reducescatter(self, array, op: str = "sum"):
        values = self._exchange("reducescatter", np.asarray(array))
        total = np.stack(values).sum(axis=0) if op == "sum" else None
        if total is None:
            raise ValueError(f"unsupported reduce op {op!r}")
        shards = np.array_split(total, self.world_size, axis=0)
        return shards[self.rank]

    def broadcast(self, array, root: int = 0):
        values = self._exchange("broadcast", np.asarray(array))
        return values[root]

    def barrier(self) -> None:
        self._exchange("barrier", 0)

    def _next_p2p(self, src: int, dst: int) -> tuple:
        # per-channel counters so send/recv pair up even when the two
        # ranks' overall op sequences differ
        if not hasattr(self, "_p2p_counters"):
            self._p2p_counters: Dict[tuple, int] = {}
        key = (src, dst)
        n = self._p2p_counters.get(key, 0)
        self._p2p_counters[key] = n + 1
        return (self.name, "p2p", src, dst, n)

    def send(self, array, dst_rank: int) -> None:
        import ray_tpu_torch

        op_id = self._next_p2p(self.rank, dst_rank)
        ref = ray_tpu_torch.put(np.asarray(array))
        ray_tpu_torch.get(self.coordinator.post.remote(op_id, 0, [ref]))

    def recv(self, src_rank: int):
        import time

        import ray_tpu_torch
        from ray_tpu_torch._private.config import Config

        op_id = self._next_p2p(src_rank, self.rank)
        timeout_s = Config.instance().collective_op_timeout_s
        deadline = time.monotonic() + timeout_s
        while True:
            refs = ray_tpu_torch.get(
                self.coordinator.collect.remote(op_id, 0, 1))
            if refs is not None:
                return ray_tpu_torch.get(refs[0])
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective recv from rank {src_rank} on rank "
                    f"{self.rank} timed out after {timeout_s:.0f}s — "
                    "no matching send arrived")
            time.sleep(0.001)


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> CollectiveGroup:
    """Join (rank 0 creates) a named store-backend group
    (reference: util/collective/collective.py init_collective_group)."""
    import ray_tpu_torch

    coordinator_name = f"__collective_{group_name}"
    cls = _coordinator_cls()
    coordinator = cls.options(
        name=coordinator_name, get_if_exists=True,
        lifetime="detached").remote(world_size)
    # p2p ops need a dedicated world_size=1 view; coordinator handles all
    group = CollectiveGroup(group_name, world_size, rank, coordinator)
    with _groups_lock:
        _groups[(group_name, rank)] = group
    return group


def get_group(group_name: str = "default", rank: int = 0) -> CollectiveGroup:
    with _groups_lock:
        group = _groups.get((group_name, rank))
    if group is None:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return group


def destroy_collective_group(group_name: str = "default") -> None:
    import ray_tpu_torch

    coordinator = None
    with _groups_lock:
        for key in [k for k in _groups if k[0] == group_name]:
            group = _groups.pop(key)
            coordinator = group.coordinator
    if coordinator is None:
        try:
            coordinator = ray_tpu_torch.get_actor(f"__collective_{group_name}")
        except Exception:  # noqa: BLE001
            return
    # kill the detached coordinator so a re-init with the same name gets a
    # fresh world_size instead of the stale detached actor
    try:
        ray_tpu_torch.kill(coordinator)
    except Exception:  # noqa: BLE001
        pass
