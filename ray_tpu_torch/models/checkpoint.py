"""Checkpointing of model and train state, with ``torch.save`` on one
card and ``torch.distributed.checkpoint`` (DCP) on a mesh.

Port of ``ray_tpu/models/checkpoint.py`` (orbax there) with its API:

    from ray_tpu_torch.models.checkpoint import CheckpointManager

    ckpt = CheckpointManager("/path/to/run1", max_to_keep=3)
    ckpt.save(step, {"params": params, "opt_state": opt_state})
    state = ckpt.restore_latest(like)   # or .restore(step, like)

A state is nested dicts, lists and tuples of tensors and Python scalars,
which covers the transformer's and the ViT's parameters and
``ClippedAdamW``'s state. Each step is a directory ``<step>/`` holding
one ``state.pt``: it is written into a temporary directory and renamed
into place, so a step exists whole or not at all, and read back with
``torch.load(weights_only=True)``. ``save`` copies the tensors to host
memory before it returns, so the caller may go on updating its tensors
in place (the train step does) while a ``wait=False`` save writes in the
background.

``restore(step)`` gives CPU tensors. ``restore(step, like)`` places each
leaf on the device and dtype of the matching leaf of ``like`` (a freshly
initialised state, say) and raises when a shape or the tree differs.

On a mesh a ``jax.Array`` carries its sharding; a rank's local tensor
does not, so a mesh state's leaves are DTensors
(``models/convert.py::checkpoint_state`` wraps a rank's parameters and
AdamW moments, ``train_state`` unwraps them). A state with DTensor
leaves is saved with DCP by every rank of the default process group
together, into a directory ``<step>/`` that holds DCP's ``.metadata``
(written under a temporary name and renamed into place by rank 0); such
a save is synchronous, and ``wait=False`` raises. ``restore(step, like)`` with
DTensor leaves in ``like`` reads each rank's shards in ``like``'s
layout, whatever the saved one was: the counterpart of orbax's restore
onto the current mesh layout. Either format restores onto either: a
one-card save onto a mesh (each rank keeps its shard of the full
tensors), a mesh save onto one card or with no ``like`` (full tensors
on the CPU, as a one-card save gives).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import warnings
from typing import Any, Dict, List, Optional

import torch

_STATE_FILE = "state.pt"
_DCP_METADATA = ".metadata"  # the file DCP writes last
# a DCP save's tree, its leaves' keys in place, as JSON (DCP would
# flatten a nested value into keys of its own)
_TREE_KEY = "__tree__"


def _dtensor_cls():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # torch < 2.4
        from torch.distributed._tensor import DTensor
    return DTensor


def _has_dtensor(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_dtensor(v) for v in tree)
    return isinstance(tree, torch.Tensor) and isinstance(tree,
                                                         _dtensor_cls())


def _flatten(tree: Any, path: str = "state") -> tuple:
    """(flat {key: leaf}, the tree with each leaf replaced by its key)."""
    flat: Dict[str, Any] = {}

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, f"{key}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{key}/{i}")
                              for i, v in enumerate(node))
        flat[key] = node
        return key

    return flat, walk(tree, path)


def _unflatten(keys: Any, flat: Dict[str, Any]) -> Any:
    if isinstance(keys, dict):
        return {k: _unflatten(v, flat) for k, v in keys.items()}
    if isinstance(keys, (list, tuple)):
        return type(keys)(_unflatten(v, flat) for v in keys)
    return flat[keys]


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _place(saved: Any, like: Any, path: str) -> Any:
    """``saved`` with each tensor moved to the device and dtype of the
    tensor at the same place in ``like``; raises where the two differ
    in structure or shape. Non-tensor leaves come from ``saved``."""
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
            got = (tuple(saved.shape) if isinstance(saved, torch.Tensor)
                   else type(saved).__name__)
            raise ValueError(f"checkpoint leaf {path} is {got}; the "
                             f"template wants {tuple(like.shape)}")
        if isinstance(like, _dtensor_cls()):  # this rank's shard of it
            from ray_tpu_torch.parallel.mesh import local_shard

            local = like.to_local()
            shard = local_shard(saved, like.placements, like.device_mesh)
            return _dtensor_cls().from_local(
                shard.to(device=local.device, dtype=local.dtype),
                like.device_mesh, like.placements, run_check=False)
        return saved.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            got = sorted(saved) if isinstance(saved, dict) else saved
            raise ValueError(f"checkpoint node {path} holds {got}; the "
                             f"template wants keys {sorted(like)}")
        return {k: _place(saved[k], v, f"{path}.{k}")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint node {path} is not a sequence of "
                             f"{len(like)} items like the template's")
        return type(like)(_place(s, t, f"{path}[{i}]")
                          for i, (s, t) in enumerate(zip(saved, like)))
    return saved


def _read_dcp_full(directory: str) -> Any:
    """A DCP save's tree with every tensor whole, on the CPU, read by
    this process alone."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    reader = dcp.FileSystemReader(directory)
    flat: Dict[str, Any] = {}
    for key, meta in reader.read_metadata().state_dict_metadata.items():
        flat[key] = (torch.empty(meta.size, dtype=meta.properties.dtype)
                     if isinstance(meta, TensorStorageMetadata) else None)
    with warnings.catch_warnings():  # no_dist: "assuming ... a single
        warnings.simplefilter("ignore", UserWarning)  # process", as meant
        dcp.load(flat, storage_reader=reader, no_dist=True)
    return _unflatten(json.loads(flat.pop(_TREE_KEY)), flat)


def _read_dcp_into(directory: str, like: Any) -> Any:
    """A DCP save read into new tensors shaped like ``like``'s (each
    DTensor this rank's shard in its layout; DCP reshards), by every
    rank of the default group."""
    import torch.distributed.checkpoint as dcp

    DTensor = _dtensor_cls()

    def empty(leaf):
        if isinstance(leaf, DTensor):
            return DTensor.from_local(torch.empty_like(leaf.to_local()),
                                      leaf.device_mesh, leaf.placements,
                                      run_check=False)
        return torch.empty_like(leaf) if isinstance(
            leaf, torch.Tensor) else leaf

    flat, keys = _flatten(like)
    flat = {k: empty(v) for k, v in flat.items()}
    dcp.load(flat, checkpoint_id=directory)
    return _unflatten(keys, flat)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 create: bool = True):
        """create=False makes a read-side manager: a missing directory
        raises instead of silently materializing an empty checkpoint
        tree (a typo'd restore path must fail loudly)."""
        self.directory = os.path.abspath(directory)
        if create:
            os.makedirs(self.directory, exist_ok=True)
        elif not os.path.isdir(self.directory):
            raise FileNotFoundError(
                f"no checkpoint directory at {self.directory}")
        self.max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[Exception] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Checkpoint ``state`` at ``step``; trims beyond max_to_keep.
        With ``wait=False`` the file is written on a background thread
        (the host copy is taken before this returns). A state with
        DTensor leaves is saved with DCP, by every rank together and
        synchronously: ``wait=False`` raises there."""
        self.wait_until_finished()
        if os.path.exists(self._step_dir(step)):
            raise ValueError(f"a checkpoint for step {step} already "
                             f"exists in {self.directory}")
        if _has_dtensor(state):
            if not wait:
                raise ValueError("a mesh (DTensor) save is synchronous: "
                                 "call save with wait=True")
            self._write_mesh(step, state)
            return
        host = _to_host(state)
        if wait:
            self._write(step, host)
            return

        def write():
            try:
                self._write(step, host)
            except Exception as exc:  # re-raised by wait_until_finished
                self._write_error = exc

        self._writer = threading.Thread(target=write, daemon=True,
                                        name=f"checkpoint-save-{step}")
        self._writer.start()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _write(self, step: int, host_state: Any) -> None:
        tmp = tempfile.mkdtemp(prefix=f".{int(step)}.", dir=self.directory)
        try:
            torch.save(host_state, os.path.join(tmp, _STATE_FILE))
            os.rename(tmp, self._step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._trim()

    def _trim(self) -> None:
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))

    def _write_mesh(self, step: int, state: Any) -> None:
        """DCP save of a DTensor tree by every rank of the default group:
        into ``.<step>.dcp`` (the same path on every rank), then renamed
        to ``<step>`` by rank 0, every rank waiting for the rename."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(self.directory, f".{int(step)}.dcp")
        lead = dist.get_rank() == 0
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
        dist.barrier()
        flat, keys = _flatten(state)
        flat[_TREE_KEY] = json.dumps(keys)
        try:
            dcp.save(flat, checkpoint_id=tmp)
            dist.barrier()
            if lead:
                os.rename(tmp, self._step_dir(step))
                self._trim()
        finally:
            dist.barrier()
            if lead:
                shutil.rmtree(tmp, ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Blocks until a ``wait=False`` save is on disk; raises its
        error if it failed."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        error, self._write_error = self._write_error, None
        if error is not None:
            raise error

    # ------------------------------------------------------------- restore
    def restore(self, step: int, like: Any = None) -> Any:
        """Restore the state saved at ``step``: CPU tensors, or, with
        ``like`` (a state of the same tree), each tensor on the device
        and dtype of ``like``'s tensor at its place; a DTensor of
        ``like`` gets this rank's shard in its layout (every rank calls
        restore together when ``like`` holds DTensors)."""
        self.wait_until_finished()
        directory = self._step_dir(step)
        path = os.path.join(directory, _STATE_FILE)
        if os.path.isfile(os.path.join(directory, _DCP_METADATA)):
            if like is not None and _has_dtensor(like):
                return _read_dcp_into(directory, like)
            saved = _read_dcp_full(directory)
        elif os.path.isfile(path):
            saved = torch.load(path, map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(
                f"no checkpoint for step {step} in {self.directory}")
        return saved if like is None else _place(saved, like, "state")

    def restore_latest(self, like: Any = None) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like)

    # ------------------------------------------------------------ metadata
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Steps on disk, in order (a save in flight is not one yet)."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and any(os.path.isfile(
                          os.path.join(self.directory, name, f))
                          for f in (_STATE_FILE, _DCP_METADATA)))

    def close(self) -> None:
        self.wait_until_finished()


def save_train_state(directory: str, step: int, params: Any,
                     opt_state: Any = None,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """One-shot convenience around CheckpointManager for train loops."""
    ckpt = CheckpointManager(directory, max_to_keep=None)
    state: Dict[str, Any] = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if extra:
        state.update(extra)
    try:
        ckpt.save(step, state)
    finally:
        ckpt.close()


def restore_train_state(directory: str, step: Optional[int] = None,
                        like: Any = None) -> Optional[Any]:
    ckpt = CheckpointManager(directory, max_to_keep=None, create=False)
    try:
        if step is None:
            return ckpt.restore_latest(like)
        return ckpt.restore(step, like)
    finally:
        ckpt.close()
