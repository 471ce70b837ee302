"""Workflow storage — durable checkpoints for steps and virtual actors.

Reference: python/ray/workflow/storage/ (base + filesystem) and
workflow_storage.py. Layout on disk:

    <root>/<workflow_id>/
        steps/<step_id>/
            input.pkl      (func, args, kwargs — enough to re-execute)
            output.pkl     (present only once the step finished)
        state.pkl          (virtual-actor state)
        meta.json          (entry step, status)
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, List, Optional

# cloudpickle so steps defined in local scopes (closures, lambdas) are
# durable, matching the reference's serializer choice. A torch tensor
# pickles with its device: one stored from the card loads back onto the
# card (and raises in a process without CUDA), never silently onto the
# CPU
try:
    import cloudpickle as pickle
except ImportError:  # pragma: no cover
    import pickle


class Storage:
    def put(self, key: str, value: Any) -> None:
        raise NotImplementedError

    def get(self, key: str, default: Any = None) -> Any:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def update(self, key: str, fn) -> Any:
        """Atomic read-modify-write: apply ``fn(current_value)`` and
        store the result, excluding concurrent updaters. Backends MUST
        implement this with a real mutual-exclusion primitive; status
        transitions (RUNNING -> CANCELED vs -> SUCCESSFUL) depend on it
        being atomic across processes — a get+put fallback here would
        silently reintroduce the cancel-overwrite race."""
        raise NotImplementedError


class FilesystemStorage(Storage):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def put(self, key: str, value: Any) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # atomic write: tmp file + rename, so a crash never leaves a
        # half-written checkpoint (reference: filesystem storage does the
        # same dance)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: str, default: Any = None) -> Any:
        path = self._path(key)
        if not os.path.exists(path):
            return default
        with open(path, "rb") as f:
            return pickle.load(f)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete_prefix(self, prefix: str) -> None:
        import shutil

        path = self._path(prefix)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.unlink(path)

    def list_prefix(self, prefix: str) -> List[str]:
        path = self._path(prefix)
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))

    def update(self, key: str, fn) -> Any:
        """Cross-process atomic read-modify-write via flock on a
        sidecar lock file (the meta file itself is replaced by put's
        atomic rename, so it cannot carry the lock)."""
        import fcntl

        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                value = fn(self.get(key))
                self.put(key, value)
                return value
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)


_global_storage: Optional[Storage] = None


def set_global_storage(storage: Storage) -> None:
    global _global_storage
    _global_storage = storage


def get_global_storage() -> Storage:
    global _global_storage
    if _global_storage is None:
        root = os.environ.get(
            "RAY_TPU_WORKFLOW_STORAGE",
            os.path.join(tempfile.gettempdir(), "ray_tpu_torch_workflows"))
        # s3://bucket/prefix routes to the S3 backend (reference ships
        # storage/s3.py next to filesystem); plain paths stay local
        from ray_tpu_torch.workflow.s3_storage import storage_from_url

        _global_storage = storage_from_url(root)
    return _global_storage
