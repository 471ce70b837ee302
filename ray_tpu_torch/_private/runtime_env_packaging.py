"""py_modules packaging: ship local module dirs to workers by URI.

Reference: python/ray/_private/runtime_env/py_modules.py + packaging.py
— a local module directory is zipped, content-addressed
(``pymod://<sha1>``), uploaded to the GCS KV, and extracted into a
node-local URI cache on first use, with refcounted GC.

Here the same shape: ``package_dir`` zips + hashes; the archive lands
in the node-local cache immediately (same-host workers hit it with no
transfer) and in the cluster KV when a ``kv_put`` is supplied (remote
nodes fetch through ``ensure_local(uri, fetch=...)``). Extraction uses
a ready-marker + per-URI lock so concurrent workers share one extract.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import threading
import time
import zipfile
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

def _default_root() -> str:
    return os.environ.get(
        "RAY_TPU_PY_MODULES_CACHE",
        os.path.join(os.path.expanduser("~"), ".ray_tpu_torch",
                     "runtime_env", "py_modules"))


# A GC candidate whose ready-marker was touched this recently is
# presumed in use by SOME process on the host (refcounts are
# per-process; the marker mtime — refreshed on every ensure_local — is
# the cross-process recency signal).
_GC_MIN_IDLE_S = 300.0

KV_NAMESPACE = "py_modules"


class PyModulesManager:
    """Node-level URI cache of packaged python modules."""

    def __init__(self, cache_root: Optional[str] = None,
                 max_cached: int = 16):
        self.cache_root = cache_root or _default_root()
        self.max_cached = max_cached
        self._lock = threading.Lock()
        self._extract_locks: Dict[str, threading.Lock] = {}
        self._refcounts: Dict[str, int] = {}
        self._last_used: Dict[str, float] = {}

    # ------------------------------------------------------------ packaging
    def package_dir(self, path: str,
                    kv_put: Optional[Callable[[bytes, bytes], None]]
                    = None) -> str:
        """Zip a local module dir, content-address it, seed the local
        cache (and the cluster KV when provided); returns the URI."""
        path = os.path.abspath(path)
        if not os.path.isdir(path):
            raise ValueError(f"py_modules entry is not a dir: {path}")
        import io

        buf = io.BytesIO()
        base = os.path.basename(path.rstrip(os.sep))
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, dirs, files in os.walk(path):
                dirs.sort()  # readdir order varies; the hash must not
                for name in sorted(files):
                    if name.endswith(".pyc"):
                        continue
                    full = os.path.join(root, name)
                    arc = os.path.join(base,
                                       os.path.relpath(full, path))
                    # fixed timestamp: the hash must depend on CONTENT
                    info = zipfile.ZipInfo(arc, (1980, 1, 1, 0, 0, 0))
                    with open(full, "rb") as f:
                        zf.writestr(info, f.read())
        blob = buf.getvalue()
        digest = hashlib.sha1(blob).hexdigest()
        uri = f"pymod://{digest}"
        archive = self._archive_path(uri)
        os.makedirs(os.path.dirname(archive), exist_ok=True)
        if not os.path.exists(archive):
            tmp = archive + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, archive)
        if kv_put is not None:
            try:
                kv_put(uri.encode(), blob)
            except Exception:  # noqa: BLE001 — local cache still serves
                logger.warning("py_modules KV upload failed for %s", uri,
                               exc_info=True)
        return uri

    def _archive_path(self, uri: str) -> str:
        return os.path.join(self.cache_root,
                            uri.split("//", 1)[1] + ".zip")

    def _extract_dir(self, uri: str) -> str:
        return os.path.join(self.cache_root, uri.split("//", 1)[1])

    # ------------------------------------------------------------ resolution
    def ensure_local(self, uri: str,
                     fetch: Optional[Callable[[bytes], Optional[bytes]]]
                     = None) -> str:
        """Return the extracted directory for a URI (a sys.path entry),
        extracting from the local archive or fetching via the supplied
        KV getter."""
        import fcntl

        target = self._extract_dir(uri)
        marker = os.path.join(target, ".ready")
        with self._lock:
            lock = self._extract_locks.setdefault(uri, threading.Lock())
        # the cache root is SHARED by every worker process on the host:
        # the in-process lock serializes threads, the flock sidecar
        # serializes processes — without it two workers rmtree/extract
        # over each other and a .ready marker blesses a partial extract
        os.makedirs(self.cache_root, exist_ok=True)
        with lock, open(target + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if os.path.exists(marker):
                    os.utime(marker)  # cross-process recency for GC
                    with self._lock:
                        self._last_used[uri] = time.monotonic()
                    return self._module_dir(target)
                archive = self._archive_path(uri)
                if not os.path.exists(archive):
                    blob = (fetch(uri.encode())
                            if fetch is not None else None)
                    if blob is None:
                        raise FileNotFoundError(
                            f"py_modules package {uri} is neither "
                            "cached locally nor fetchable from the "
                            "cluster KV")
                    os.makedirs(os.path.dirname(archive), exist_ok=True)
                    tmp = archive + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(blob)
                    os.replace(tmp, archive)
                if os.path.exists(target):
                    shutil.rmtree(target, ignore_errors=True)
                with zipfile.ZipFile(archive) as zf:
                    zf.extractall(target)
                with open(marker, "w"):
                    pass
                with self._lock:
                    self._last_used[uri] = time.monotonic()
                return self._module_dir(target)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    @staticmethod
    def _module_dir(target: str) -> str:
        """The archive wraps the packaged dir under its basename; the
        sys.path entry is that INNER dir, preserving the plain-path
        py_modules semantics (modules inside the dir import)."""
        entries = [e for e in os.listdir(target) if e != ".ready"]
        if len(entries) == 1 and os.path.isdir(
                os.path.join(target, entries[0])):
            return os.path.join(target, entries[0])
        return target

    # ------------------------------------------------------------ refcounts
    def acquire(self, uri: str) -> None:
        with self._lock:
            self._refcounts[uri] = self._refcounts.get(uri, 0) + 1
            self._last_used[uri] = time.monotonic()

    def release(self, uri: str) -> None:
        with self._lock:
            n = self._refcounts.get(uri, 0) - 1
            if n <= 0:
                self._refcounts.pop(uri, None)
            else:
                self._refcounts[uri] = n
        self._maybe_gc()

    def _maybe_gc(self) -> None:
        """Zero-ref extract dirs + archives beyond max_cached go, LRU
        first (reference: URI refcount GC in the runtime-env agent)."""
        import fcntl

        from ray_tpu_torch._private.runtime_env_installer import gc_zero_ref_lru

        def cleanup(d: str) -> None:
            # the cache root is host-shared and refcounts are
            # per-process, so two cross-process guards apply: the
            # extraction flock (non-blocking — a URI being extracted or
            # staged RIGHT NOW is skipped), and a ready-marker recency
            # window (ensure_local touches the marker, so an extract
            # another process used in the last _GC_MIN_IDLE_S is
            # presumed live). The lock file itself is never unlinked:
            # deleting an flock'd inode would silently hand the next
            # opener a different lock.
            target = os.path.join(self.cache_root, d)
            try:
                if time.time() - os.path.getmtime(
                        os.path.join(target, ".ready")) < _GC_MIN_IDLE_S:
                    return
            except OSError:
                pass  # no marker: half-extracted leftovers are fair game
            try:
                with open(target + ".lock", "w") as lockf:
                    fcntl.flock(lockf,
                                fcntl.LOCK_EX | fcntl.LOCK_NB)
                    try:
                        shutil.rmtree(target, ignore_errors=True)
                        archive = target + ".zip"
                        if os.path.exists(archive):
                            os.unlink(archive)
                    finally:
                        fcntl.flock(lockf, fcntl.LOCK_UN)
            except OSError:
                return  # busy: survive this GC round

        gc_zero_ref_lru(
            cache_root=self.cache_root, max_cached=self.max_cached,
            scheme="pymod", lock=self._lock,
            refcounts=self._refcounts, last_used=self._last_used,
            cleanup=cleanup)

    def stats(self) -> dict:
        with self._lock:
            return {"refcounts": dict(self._refcounts)}


_default: Optional[PyModulesManager] = None
_default_lock = threading.Lock()


def default_py_modules_manager() -> PyModulesManager:
    global _default
    with _default_lock:
        if _default is None:
            _default = PyModulesManager()
        return _default


def cluster_kv_put() -> Optional[Callable[[bytes, bytes], None]]:
    """KV writer bound to the active runtime, when one exists."""
    try:
        from ray_tpu_torch.core import runtime as rt_mod

        rt = rt_mod.global_runtime
        if rt is None:
            return None
        return lambda key, value: rt.kv_put(KV_NAMESPACE, key, value)
    except Exception:  # noqa: BLE001
        return None


def cluster_kv_get() -> Optional[Callable[[bytes], Optional[bytes]]]:
    try:
        from ray_tpu_torch.core import runtime as rt_mod

        rt = rt_mod.global_runtime
        if rt is None:
            return None
        return lambda key: rt.kv_get(KV_NAMESPACE, key)
    except Exception:  # noqa: BLE001
        return None
