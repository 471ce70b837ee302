"""Durable KV for the Serve control plane.

Reference: python/ray/serve/storage/kv_store.py — the controller
checkpoints its goal state through a pluggable KV (GCS internal KV by
default, S3/local alternatives) and recovers it on restart. Here the
default backend is the runtime's internal KV, which lives in the
Runtime/GCS — NOT in the controller actor — so it survives controller
death; a filesystem backend covers fully-external durability."""

from __future__ import annotations

import os
from typing import List, Optional

_NS = "serve"


class KVStore:
    """Runtime-internal KV, namespaced (reference: RayInternalKVStore)."""

    def __init__(self, namespace: str = _NS):
        self._ns = namespace

    def _rt(self):
        from ray_tpu_torch.core import runtime as rt_mod

        rt = rt_mod.global_runtime
        if rt is None or rt.is_shutdown:
            raise RuntimeError("runtime not initialized")
        return rt

    def put(self, key: bytes, value: bytes) -> None:
        self._rt().kv_put(self._ns, bytes(key), bytes(value))

    def get(self, key: bytes) -> Optional[bytes]:
        return self._rt().kv_get(self._ns, bytes(key))

    def delete(self, key: bytes) -> None:
        self._rt().kv_del(self._ns, bytes(key))

    def keys(self, prefix: bytes = b"") -> List[bytes]:
        return self._rt().kv_keys(self._ns, prefix)


class LocalDiskKVStore:
    """Filesystem-backed KV (reference: serve/storage/kv_store.py
    RayLocalKVStore) — survives whole-cluster restarts."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: bytes) -> str:
        return os.path.join(self.root, key.hex())

    def put(self, key: bytes, value: bytes) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, self._path(key))

    def get(self, key: bytes) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: bytes) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:  # raycheck: disable=RC05 — delete is idempotent; a missing file is the already-deleted success case
            pass

    def keys(self, prefix: bytes = b"") -> List[bytes]:
        out = []
        for name in os.listdir(self.root):
            if name.endswith(".tmp"):
                continue
            try:
                key = bytes.fromhex(name)
            except ValueError:
                continue
            if key.startswith(prefix):
                out.append(key)
        return out
