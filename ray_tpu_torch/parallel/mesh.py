"""Device mesh management for multi-axis parallelism.

Port of ``ray_tpu/parallel/mesh.py``. The JAX package runs one SPMD
program over a ``jax.sharding.Mesh``; here every rank is a process of a
``torch.distributed`` group (``parallel/multihost.py`` joins it) and the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over those ranks
whose named dimensions carry the parallelism kinds:

  dp  data parallelism (batch sharding; FSDP rides this axis too)
  pp  pipeline parallelism (layer stages)
  sp  sequence/context parallelism (ring attention, Ulysses)
  tp  tensor parallelism (heads / hidden sharding)

Expert parallelism (ep) rides the dp axis, as in the JAX package. Axis
sizes multiply to the rank count; size-1 axes are legal.

``spec_for`` gives a tensor's per-dimension mesh axes (the JAX
package's ``PartitionSpec``, as a tuple) and ``sharding_for`` the DTensor
placements of that record, one per mesh dimension. ``shard_map`` is the
counterpart of ``jax.shard_map`` in a program whose ranks already hold
their local shards: it binds the mesh whose axis names the collectives
(``collective.api.ici``) resolve. ``RankLayout`` is what the model's
layers read of a mesh (dp and tp sizes and ranks, FSDP) and the
collectives they issue where GSPMD would insert them in the JAX
package; ``local_shard`` cuts a rank's shard of a full tensor.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device

AXIS_ORDER = ("dp", "pp", "sp", "tp")

# Canonical logical-axis -> mesh-axis rules for transformer state
# (models/transformer.py logical_axes).
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": "dp",
    "seq": "sp",
    "heads": "tp",
    "kv_heads": "tp",
    "hidden": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": "pp",
    "experts": "dp",   # expert parallelism over the dp axis
    "stage": "pp",
}


@dataclass(frozen=True)
class MeshSpec:
    """A named factorization of the rank count."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.tp)

    @classmethod
    def auto(cls, n_devices: int, *, want_pp: bool = True,
             want_sp: bool = True, want_tp: bool = True) -> "MeshSpec":
        """Greedy factorization: give tp, then sp, then pp a factor of 2
        each (neighbor axes first), remainder to dp."""
        remaining = n_devices
        tp = 2 if want_tp and remaining % 2 == 0 and remaining >= 2 else 1
        remaining //= tp
        sp = 2 if want_sp and remaining % 2 == 0 and remaining >= 2 else 1
        remaining //= sp
        pp = 2 if want_pp and remaining % 2 == 0 and remaining >= 2 else 1
        remaining //= pp
        return cls(dp=remaining, pp=pp, sp=sp, tp=tp)


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def device_mesh(device_type, ranks: torch.Tensor, names: Sequence[str]):
    """A DeviceMesh of ``ranks`` (an int tensor shaped like the mesh)
    named ``names``, on ``device_type`` (CUDA unless the caller asks for
    the CPU). Every rank of the group calls it: it creates the mesh
    dimensions' process groups."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs torch.distributed initialized "
            "(ray_tpu_torch.parallel.multihost.initialize)")
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def build_mesh(spec: MeshSpec, device_type=None):
    """The first ``spec.size`` ranks as a DeviceMesh named AXIS_ORDER."""
    have = world_size()
    if have < spec.size:
        raise ValueError(f"mesh needs {spec.size} devices, have {have}")
    return device_mesh(
        device_type, torch.arange(spec.size).reshape(spec.axis_sizes()),
        AXIS_ORDER)


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Dict[str, Optional[str]]] = None
             ) -> Tuple[Optional[str], ...]:
    """Map logical array axes to mesh axes through the rule table: one
    entry per tensor dimension, the mesh axis that shards it or None."""
    rules = rules or DEFAULT_RULES
    return tuple(None if ax is None else rules.get(ax)
                 for ax in logical_axes)


def sharding_for(mesh, logical_axes: Sequence[Optional[str]],
                 rules: Optional[Dict[str, Optional[str]]] = None) -> tuple:
    """The DTensor placements of ``spec_for(logical_axes, rules)`` on
    ``mesh``: per mesh dimension, ``Shard(d)`` for the tensor dimension
    it shards, else ``Replicate()``."""
    try:  # imported here: it takes ~1 s, and a model import needs none
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:  # torch < 2.4
        from torch.distributed._tensor import Replicate, Shard

    spec = spec_for(logical_axes, rules)
    names = mesh.mesh_dim_names
    for axis in spec:
        if axis is not None and axis not in names:
            raise ValueError(f"mesh axis {axis!r} of {spec} is not one of "
                             f"the mesh's {names}")
        if axis is not None and spec.count(axis) > 1:
            raise ValueError(f"mesh axis {axis!r} shards two dimensions "
                             f"of {spec}")
    return tuple(Shard(spec.index(n)) if n in spec else Replicate()
                 for n in names)


def fsdp_rules(rules: Optional[Dict[str, Optional[str]]] = None
               ) -> Dict[str, Optional[str]]:
    """Variant rule table that additionally shards parameters' hidden axis
    over dp — fully-sharded data parallelism."""
    out = dict(rules or DEFAULT_RULES)
    out["hidden"] = "dp"
    return out


def local_shard(x: torch.Tensor, placements: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``placements``
    (what a device of the JAX mesh holds of a NamedSharding array), as a
    contiguous copy."""
    coord = mesh.get_coordinate()
    for dim, placement in enumerate(placements):
        if placement.is_shard():
            n = mesh.size(dim)
            if x.shape[placement.dim] % n:
                raise ValueError(
                    f"dimension {placement.dim} of size "
                    f"{x.shape[placement.dim]} does not split over mesh "
                    f"axis {mesh.mesh_dim_names[dim]} of size {n}")
            x = x.chunk(n, dim=placement.dim)[coord[dim]]
    return x.contiguous()


@dataclass(frozen=True)
class RankLayout:
    """What the model's layers need of a mesh: the dp, tp and sp sizes,
    this rank's place along each, whether the parameters' hidden axis is
    sharded over dp (FSDP), and the collectives over those axes that the
    layers call. Each collective binds the mesh itself, so a
    checkpointed layer's recompute (in autograd's thread) finds it.
    Under GSPMD the JAX package gets these collectives from XLA."""

    mesh: object
    dp: int = 1
    dp_rank: int = 0
    tp: int = 1
    tp_rank: int = 0
    fsdp: bool = False
    sp: int = 1
    sp_rank: int = 0

    @classmethod
    def of(cls, mesh, fsdp: bool = False) -> "RankLayout":
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        dp, tp, sp = (sizes.get(a, 1) for a in ("dp", "tp", "sp"))
        return cls(mesh, dp, mesh.get_local_rank("dp") if dp > 1 else 0,
                   tp, mesh.get_local_rank("tp") if tp > 1 else 0,
                   fsdp and dp > 1, sp,
                   mesh.get_local_rank("sp") if sp > 1 else 0)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` summed over ``axis`` (differentiable; as is when the
        axis has one rank)."""
        if self._size(axis) == 1:
            return x
        from ray_tpu_torch.collective.api import ici

        with shard_map(self.mesh):
            return ici.allreduce(x, axis)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise max over ``axis``, outside autograd."""
        if self._size(axis) == 1:
            return x.detach()
        from ray_tpu_torch.collective.api import ici

        with shard_map(self.mesh):
            return ici.allreduce(x, axis, op="max")

    def gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in rank
        order; its backward is the reduce-scatter."""
        if self._size(axis) == 1:
            return x
        from ray_tpu_torch.collective.api import ici

        with shard_map(self.mesh):
            out = ici.allgather(x.movedim(dim, 0), axis, tiled=True)
        return out.movedim(0, dim)

    def stack(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` stacked on a new leading dim."""
        if self._size(axis) == 1:
            return x[None]
        from ray_tpu_torch.collective.api import ici

        with shard_map(self.mesh):
            return ici.allgather(x, axis)

    def stack_data(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` over the data axes, [dp, sp, ...] in rank
        order."""
        return self.stack(self.stack(x, "sp"), "dp")

    def psum_data(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data axes, dp and sp."""
        return self.psum(self.psum(x, "sp"), "dp")

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis``, this rank's chunk of dim 0; its
        backward is the all-gather."""
        from ray_tpu_torch.collective.api import ici

        with shard_map(self.mesh):
            return ici.reducescatter(x, axis)

    def alltoall(self, x: torch.Tensor, axis: str, split: int,
                 concat: int) -> torch.Tensor:
        from ray_tpu_torch.collective.api import ici

        with shard_map(self.mesh):
            return ici.alltoall(x, axis, split, concat)

    def _size(self, axis: str) -> int:
        return {"dp": self.dp, "tp": self.tp, "sp": self.sp}[axis]


# -- the counterpart of shard_map --------------------------------------------

_CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def shard_map(mesh):
    """Run the body with ``mesh`` bound: inside it, ``ici.*(x, axis)``,
    ``axis_index`` and ``axis_size`` resolve axis names on ``mesh``.
    Each rank's tensors are its local shards already, so nothing is
    split or gathered on the way in or out. A function that may run in
    autograd's threads (a checkpointed layer's recompute) enters it
    itself, as ``models/training.py``'s attention functions do."""
    token = _CURRENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT_MESH.reset(token)


def current_mesh():
    mesh = _CURRENT_MESH.get()
    if mesh is None:
        raise RuntimeError("no mesh bound: call inside "
                           "ray_tpu_torch.parallel.shard_map(mesh)")
    return mesh


def axis_size(axis: str) -> int:
    """Ranks along mesh axis ``axis`` (``lax.axis_size``)."""
    mesh = current_mesh()
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(axis: str) -> int:
    """This rank's position along mesh axis ``axis``
    (``lax.axis_index``)."""
    return current_mesh().get_local_rank(axis)
