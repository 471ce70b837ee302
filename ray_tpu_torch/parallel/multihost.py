"""Multi-host bring-up: process-group init and DCN x ICI meshes.

Port of ``ray_tpu/parallel/multihost.py``. The JAX package joins every
host process to a ``jax.distributed`` coordinator; here every rank joins
a ``torch.distributed`` process group (NCCL on CUDA, or gloo when the
caller names it) through the same environment variables, and the mesh
is a ``DeviceMesh`` over the group's ranks.

Mesh layout rule (scaling-book recipe): put the axis with the least
communication volume per step (dp, then pp) across nodes — slowest in
rank order, since ranks are numbered node by node — and keep
tensor/sequence-parallel axes within a node.

``RankPool`` is the port's own: it starts N ranks of one host as
spawned processes that join one group and run functions on request, the
job a cluster launcher does for ``jax.distributed``'s hosts. Over NCCL
each rank takes a card of its own (``cuda_device="per_rank"``: rank r on
card r), the counterpart of a JAX mesh's n chips. With gloo and one card,
four ranks can share ``cuda:0`` (NCCL refuses two ranks on one device;
``initialize`` checks that before NCCL starts).
"""

from __future__ import annotations

import logging
import os
import shutil
import socket
import tempfile
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

_DEVICE_KEY = "ray_tpu_torch/device/{}"


def _init_method(coordinator_address: str) -> str:
    """``host:port`` (the JAX coordinator's form) -> ``tcp://host:port``;
    a URL (``tcp://``, ``file://``) is taken as it is."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _make_store(init_method: str, world: int, rank: int,
                timeout: timedelta):
    import torch.distributed as dist

    if init_method.startswith("file://"):
        return dist.FileStore(init_method[len("file://"):], world)
    if init_method.startswith("tcp://"):
        host, port = init_method[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), world, is_master=rank == 0,
                             timeout=timeout)
    raise ValueError(f"coordinator address {init_method!r}: expected "
                     f"host:port, tcp://host:port or file://path")


def check_one_rank_per_device(store, rank: int, world: int,
                              device_key: str) -> None:
    """Raises on every rank when two ranks of the group name one device
    (``device_key``: host and device UUID): NCCL gives each rank a device
    of its own. Exchanged through ``store`` before NCCL starts."""
    store.set(_DEVICE_KEY.format(rank), device_key)
    keys = [store.get(_DEVICE_KEY.format(r)).decode() for r in range(world)]
    for r, key in enumerate(keys):
        if key in keys[:r]:
            raise RuntimeError(
                f"NCCL needs one device per rank: ranks "
                f"{keys.index(key)} and {r} are both on {key}; give each "
                f"rank its own card (torch.cuda.set_device), or name "
                f"backend='gloo'")


def _device_key() -> str:
    import torch

    index = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', index)}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> bool:
    """``torch.distributed.init_process_group`` with env auto-detection
    (``RAY_TPU_COORDINATOR``, ``RAY_TPU_NUM_PROCESSES``,
    ``RAY_TPU_PROCESS_ID``); no-op (False) for single-process runs so
    the same script works on one host and on N.

    ``backend``: NCCL (CUDA; a process sees its card through
    ``torch.cuda.set_device`` before this call) unless the caller names
    ``"gloo"``. NCCL with two ranks on one device raises; nothing
    switches backend on its own. Collectives time out after
    ``Config.collective_op_timeout_s``."""
    import torch.distributed as dist

    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch._private.device import resolve_device

    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "RAY_TPU_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("RAY_TPU_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("RAY_TPU_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes in (None, 1):
        return False  # single host, nothing to join
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the process count "
            "and this process's id (arguments or RAY_TPU_COORDINATOR, "
            "RAY_TPU_NUM_PROCESSES, RAY_TPU_PROCESS_ID)")
    backend = backend or "nccl"
    if backend == "nccl":
        resolve_device(None)  # raises without CUDA
    timeout = timedelta(seconds=Config.instance().collective_op_timeout_s)
    store = _make_store(_init_method(coordinator_address), num_processes,
                        process_id, timeout)
    if backend == "nccl":
        check_one_rank_per_device(store, process_id, num_processes,
                                  _device_key())
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return True


def multihost_mesh(axes: Dict[str, int],
                   dcn_axes: Optional[Sequence[str]] = None,
                   device_type=None):
    """A DeviceMesh named by ``axes`` (ordered {name: size}, product =
    the rank count) whose ``dcn_axes`` (default: the leading axis) vary
    slowest in rank order, so they span nodes while the rest stay within
    one. ``device_type``: CUDA unless the caller asks for the CPU."""
    import torch

    from ray_tpu_torch.parallel.mesh import device_mesh, world_size

    names = list(axes.keys())
    total = 1
    for n in names:
        total *= axes[n]
    n_devices = world_size()
    if total != n_devices:
        raise ValueError(
            f"mesh axes {axes} need {total} devices, have {n_devices}")
    if dcn_axes is None:
        dcn_axes = names[:1]
    order = ([n for n in names if n in dcn_axes]
             + [n for n in names if n not in dcn_axes])
    ranks = torch.arange(total).reshape([axes[n] for n in order]).permute(
        [order.index(n) for n in names]).contiguous()
    return device_mesh(device_type, ranks, names)


def process_count() -> int:
    from ray_tpu_torch.parallel.mesh import world_size

    return world_size()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def sync_global_devices(name: str = "barrier") -> None:
    """Cross-host barrier: one all-reduce of ones over every rank
    (reference: collective.barrier); nothing to wait for in one
    process."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ones = torch.ones(1, device=device)
    dist.all_reduce(ones)
    if int(ones.item()) != dist.get_world_size():
        raise RuntimeError(f"sync_global_devices({name}): {ones.item()} "
                           f"ranks answered of {dist.get_world_size()}")
    logger.debug("sync_global_devices(%s) complete", name)


# -- local ranks --------------------------------------------------------------


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               cuda_device: Optional[int], env: Dict[str, str],
               conn) -> None:
    """A RankPool process: join the group, then run each function the
    pool sends until it sends an empty message."""
    import cloudpickle

    import torch

    os.environ.update(env)
    try:
        # the ranks share the host's cores: intra-op threads past a
        # rank's share only contend (on the CPU a debug-model pipeline
        # step ran 100x slower with every rank on all 8)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if cuda_device is not None:
            torch.cuda.set_device(cuda_device)
        initialize(init_method, world, rank, backend=backend)
        conn.send_bytes(cloudpickle.dumps(("ok", None)))
    except BaseException:  # noqa: BLE001 — reported to the pool, then exit
        conn.send_bytes(cloudpickle.dumps(
            ("error", traceback.format_exc())))
        return
    try:
        while True:
            msg = conn.recv_bytes()
            if not msg:
                break
            try:
                fn, args, kwargs = cloudpickle.loads(msg)
                out = ("ok", fn(*args, **kwargs))
            except Exception:  # noqa: BLE001 — the pool raises it
                out = ("error", traceback.format_exc())
            conn.send_bytes(cloudpickle.dumps(out))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def rank_devices(world: int, cuda_device) -> List[Optional[int]]:
    """The card each of ``world`` ranks sets before it joins: None (no
    ``set_device``), one index for every rank, or ``"per_rank"`` (rank r
    on card r)."""
    if cuda_device == "per_rank":
        return list(range(world))
    if cuda_device is None or isinstance(cuda_device, int):
        return [cuda_device] * world
    raise ValueError(f"cuda_device must be None, a card index or "
                     f"'per_rank'; got {cuda_device!r}")


def check_cards(world: int, devices: Sequence[Optional[int]],
                backend: Optional[str]) -> None:
    """Raises, before any rank starts, when the cards the ranks name are
    not all visible, naming both counts when NCCL ranks have a card of
    their own each."""
    named = [d for d in devices if d is not None]
    if not named:
        return
    import torch

    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    per_rank = len(set(named)) == world
    if (backend or "nccl") == "nccl" and per_rank and visible < world:
        raise RuntimeError(
            f"NCCL with one card a rank: {world} ranks need {world} "
            f"visible CUDA cards, {visible} visible")
    if max(named) >= visible:
        raise RuntimeError(f"the ranks name card {max(named)}; {visible} "
                           f"visible CUDA cards")


class RankPool:
    """``world`` ranks of this host as spawned processes in one process
    group; ``run(fn, *args)`` calls ``fn(*args)`` on every rank and
    returns the results by rank.

    Functions travel by cloudpickle (a function of a module that
    ``cloudpickle.register_pickle_by_value`` names, or of ``__main__``,
    travels by value). The group rendezvous in a file of a temporary
    directory, so pools never race for a port. ``cuda_device``: each
    rank's ``torch.cuda.set_device`` before it joins: one card for all,
    or ``"per_rank"`` (rank r on card r: NCCL's one rank a card); cards
    the host does not show raise before any rank starts
    (``check_cards``). The ranks split the host's cores for their
    intra-op threads. ``env``: set in each rank before it joins. A rank
    that raises, or no answer within ``timeout_s``, ends every rank and
    raises here; the next ``run`` starts them anew."""

    def __init__(self, world: int, *, backend: Optional[str] = None,
                 cuda_device=None,
                 env: Optional[Dict[str, str]] = None,
                 timeout_s: float = 600.0):
        self.world = world
        self.backend = backend
        self.devices = rank_devices(world, cuda_device)
        self.env = dict(env or {})
        self.timeout_s = timeout_s
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self._dir: Optional[str] = None

    def start(self) -> "RankPool":
        import multiprocessing

        if self._procs:
            return self
        check_cards(self.world, self.devices, self.backend)
        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="ray_tpu_torch_ranks_")
        init = f"file://{os.path.join(self._dir, 'store')}"
        for rank in range(self.world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, self.world, init, self.backend,
                      self.devices[rank], self.env, child))
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        self._collect("start")
        return self

    def _collect(self, what: str) -> list:
        """Every rank's answer, in rank order. The first failure ends the
        wait: its peers may be blocked in a collective with it."""
        import time
        from multiprocessing.connection import wait

        import cloudpickle

        results: List[Any] = [None] * self.world
        pending = {conn: rank for rank, conn in enumerate(self._conns)}
        errors: List[str] = []
        deadline = time.monotonic() + self.timeout_s
        while pending and not errors:
            ready = wait(list(pending),
                         timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                errors.append(f"ranks {sorted(pending.values())}: no answer "
                              f"to {what} within {self.timeout_s:.0f} s")
            for conn in ready:
                rank = pending.pop(conn)
                try:
                    status, value = cloudpickle.loads(conn.recv_bytes())
                except EOFError:
                    errors.append(f"rank {rank}: exited during {what} (code "
                                  f"{self._procs[rank].exitcode})")
                    continue
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        if errors:
            self.close()
            raise RuntimeError(f"RankPool {what} failed:\n"
                               + "\n".join(errors))
        return results

    def run(self, fn: Callable, *args, **kwargs) -> list:
        import cloudpickle

        self.start()
        msg = cloudpickle.dumps((fn, args, kwargs))
        for conn in self._conns:
            conn.send_bytes(msg)
        return self._collect(getattr(fn, "__name__", "run"))

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send_bytes(b"")
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self) -> "RankPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
