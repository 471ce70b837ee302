"""Checkpointing of model and train state, with ``torch.save``.

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
initialised state, say) and raises when a shape or the tree differs: the
one-card counterpart of orbax's restore onto the current mesh layout. A
sharded restore across layouts waits for the mesh port.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional

import torch

_STATE_FILE = "state.pt"


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
        (the host copy is taken before this returns)."""
        self.wait_until_finished()
        if os.path.exists(self._step_dir(step)):
            raise ValueError(f"a checkpoint for step {step} already "
                             f"exists in {self.directory}")
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
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))

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
        and dtype of ``like``'s tensor at its place."""
        self.wait_until_finished()
        path = os.path.join(self._step_dir(step), _STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"no checkpoint for step {step} in {self.directory}")
        saved = torch.load(path, map_location="cpu", weights_only=True)
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
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, _STATE_FILE)))

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
