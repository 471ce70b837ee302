"""Runtime-env pip installer: real venvs, URI-cached, refcounted.

Reference: python/ray/_private/runtime_env/pip.py (creates a virtualenv
per unique pip spec, lazily, on the node that runs the task) and
packaging.py (URI-keyed cache with refcounted GC). Here:

  - Each unique sorted pip spec hashes to a ``pip://<sha1>`` URI whose
    venv lives under the cache root; creation happens once, concurrent
    requests for the same URI share one build (ready-marker + lock).
  - Tasks/actors using the env acquire the URI; release at completion.
    Zero-ref envs are deleted LRU when the cache exceeds
    ``max_cached_envs`` (reference: URI reference counting in
    runtime-env agent).
  - Workers (threads or OS processes) see the env through its
    site-packages directory: appended to ``sys.path`` in-process and to
    ``PYTHONPATH`` for child processes by RuntimeEnv.applied().

Zero-egress note: package specs resolvable offline (local wheels,
local project dirs, already-cached sdists) install for real; specs
needing the network fail the pip run and surface as a task error,
unless the package is already importable in the parent interpreter
(graceful fallback so pre-baked packages keep working).
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_DEFAULT_CACHE_ROOT = os.path.join(
    os.path.expanduser("~"), ".ray_tpu_torch", "runtime_env", "pip")


def gc_zero_ref_lru(cache_root: str, max_cached: int, scheme: str,
                    lock: threading.Lock, refcounts: Dict[str, int],
                    last_used: Dict[str, float], cleanup) -> None:
    """Shared zero-ref LRU eviction over a URI cache directory
    (reference: runtime-env agent URI GC). ``cleanup(dirname)`` removes
    one entry's on-disk state — the only part that differs between the
    pip/conda env caches and the py_modules package cache."""
    with lock:
        if not os.path.isdir(cache_root):
            return
        on_disk = [d for d in os.listdir(cache_root)
                   if os.path.isdir(os.path.join(cache_root, d))]
        if len(on_disk) <= max_cached:
            return
        victims = []
        for d in on_disk:
            uri = f"{scheme}://{d}"
            if refcounts.get(uri, 0) == 0:
                victims.append((last_used.get(uri, 0.0), uri, d))
        victims.sort()
        doomed = victims[:len(on_disk) - max_cached]
        for _, uri, _d in doomed:
            last_used.pop(uri, None)
    for _, uri, d in doomed:
        logger.info("GC runtime-env cache entry %s", uri)
        cleanup(d)


class PipEnvManager:
    """Node-level manager of pip virtualenvs (one per unique spec)."""

    URI_SCHEME = "pip"

    def __init__(self, cache_root: Optional[str] = None,
                 max_cached_envs: int = 8):
        self.cache_root = cache_root or _DEFAULT_CACHE_ROOT
        self.max_cached_envs = max_cached_envs
        self._lock = threading.Lock()
        self._build_locks: Dict[str, threading.Lock] = {}
        self._refcounts: Dict[str, int] = {}
        self._last_used: Dict[str, float] = {}

    # ------------------------------------------------------------- identity
    @classmethod
    def uri_for(cls, packages: List[str]) -> str:
        digest = hashlib.sha1(
            "\n".join(sorted(packages)).encode()).hexdigest()
        return f"{cls.URI_SCHEME}://{digest}"

    def _env_dir(self, uri: str) -> str:
        return os.path.join(self.cache_root, uri.split("//", 1)[1])

    def site_packages(self, uri: str) -> Optional[str]:
        matches = glob.glob(os.path.join(
            self._env_dir(uri), "lib", "python*", "site-packages"))
        return matches[0] if matches else None

    # ------------------------------------------------------------- creation
    def get_or_create(self, packages: List[str],
                      timeout_s: float = 300.0) -> Tuple[str, str]:
        """Return (uri, site_packages_dir), building the venv if needed."""
        uri = self.uri_for(packages)
        env_dir = self._env_dir(uri)
        marker = os.path.join(env_dir, ".ready")
        with self._lock:
            build_lock = self._build_locks.setdefault(
                uri, threading.Lock())
        with build_lock:
            if not os.path.exists(marker):
                self._build(env_dir, packages, timeout_s)
                with open(marker, "w") as f:
                    f.write(" ".join(sorted(packages)))
            with self._lock:
                self._last_used[uri] = time.monotonic()
        site = self.site_packages(uri)
        if site is None:
            raise RuntimeError(
                f"pip env {uri} has no site-packages directory")
        return uri, site

    def _build(self, env_dir: str, packages: List[str],
               timeout_s: float) -> None:
        logger.info("creating pip runtime env at %s for %s", env_dir,
                    packages)
        if os.path.exists(env_dir):
            shutil.rmtree(env_dir, ignore_errors=True)
        os.makedirs(os.path.dirname(env_dir), exist_ok=True)
        try:
            subprocess.run(
                [sys.executable, "-m", "venv", "--without-pip", env_dir],
                check=True, capture_output=True, timeout=timeout_s)
            # drive the PARENT interpreter's pip with --target into the
            # venv's site dir: works offline (no ensurepip download) and
            # installs wheels/local projects exactly like the reference's
            # `pip install -r` inside the env
            lib = glob.glob(os.path.join(env_dir, "lib", "python*"))
            site = os.path.join(
                lib[0] if lib else os.path.join(
                    env_dir, "lib",
                    f"python{sys.version_info.major}."
                    f"{sys.version_info.minor}"),
                "site-packages")
            os.makedirs(site, exist_ok=True)
            proc = subprocess.run(
                [sys.executable, "-m", "pip", "install",
                 "--disable-pip-version-check", "--no-input",
                 "--target", site, *packages],
                capture_output=True, text=True, timeout=timeout_s)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"pip install {packages} failed:\n{proc.stderr}")
        except BaseException:
            shutil.rmtree(env_dir, ignore_errors=True)
            raise

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
        """Delete zero-ref envs, oldest first, down to max_cached_envs
        (reference: URI cache GC in runtime-env agent)."""
        gc_zero_ref_lru(
            cache_root=self.cache_root, max_cached=self.max_cached_envs,
            scheme=self.URI_SCHEME, lock=self._lock,
            refcounts=self._refcounts, last_used=self._last_used,
            cleanup=lambda d: shutil.rmtree(
                os.path.join(self.cache_root, d), ignore_errors=True))

    def stats(self) -> dict:
        with self._lock:
            return {"refcounts": dict(self._refcounts),
                    "cached": (os.listdir(self.cache_root)
                               if os.path.isdir(self.cache_root) else [])}


_default_manager: Optional[PipEnvManager] = None
_default_lock = threading.Lock()


def default_manager() -> PipEnvManager:
    global _default_manager
    with _default_lock:
        if _default_manager is None:
            _default_manager = PipEnvManager()
        return _default_manager


class CondaEnvManager(PipEnvManager):
    """Conda env materialization (reference:
    _private/runtime_env/conda.py creates envs with `conda env create`).

    Spec: the conda-environment dict shape — {"dependencies": ["numpy",
    "pkg=1.2", {"pip": ["wheelpath"]}], ...} — or a plain list of
    dependency strings. Two build paths:

      - a conda/mamba/micromamba binary on PATH: the real thing —
        `conda env create -p <env_dir> -f <generated yml>`.
      - OFFLINE (this image ships no conda): dependencies materialize
        through the same pip --target machinery the pip manager uses —
        conda pins ("pkg=1.2", single '=') translate to pip pins
        ("pkg==1.2"), the "pip:" sublist passes through, and
        python/conda-infra pins are skipped. The env dir is real either
        way; URI cache + refcounted GC are inherited.
    """

    URI_SCHEME = "conda"

    # conda-infrastructure deps that have no pip equivalent
    _SKIP = ("python", "pip", "setuptools", "wheel", "conda")

    @classmethod
    def canonical_deps(cls, spec) -> List[str]:
        """Flatten a conda spec to a sorted dependency list (the URI
        identity and the offline install plan)."""
        if isinstance(spec, dict):
            deps = list(spec.get("dependencies") or [])
        else:
            deps = list(spec)
        flat: List[str] = []
        for dep in deps:
            if isinstance(dep, dict):
                flat.extend(f"pip:{p}" for p in dep.get("pip", []))
            else:
                flat.append(str(dep))
        return sorted(flat)

    @staticmethod
    def conda_binary() -> Optional[str]:
        for name in ("conda", "mamba", "micromamba"):
            path = shutil.which(name)
            if path:
                return path
        return None

    def get_or_create_spec(self, spec,
                           timeout_s: float = 600.0) -> Tuple[str, str]:
        return self.get_or_create(self.canonical_deps(spec), timeout_s)

    def _build(self, env_dir: str, packages: List[str],
               timeout_s: float) -> None:
        conda = self.conda_binary()
        if conda is not None:
            self._build_with_conda(conda, env_dir, packages, timeout_s)
            return
        # offline: translate to pip specs and reuse the parent-pip
        # --target build
        logger.info("conda (offline pip materialization) at %s: %s",
                    env_dir, packages)
        super()._build(env_dir, self.to_pip_specs(packages), timeout_s)

    @classmethod
    def to_pip_specs(cls, packages: List[str]) -> List[str]:
        """Conda dependency strings -> pip requirement specs. Only the
        bare single-'=' conda pin ("pkg=1.2") needs rewriting to
        "pkg==1.2"; range operators (>=, <=, >, <, !=, ==) are already
        valid pip syntax and must pass through untouched."""
        import re

        specs: List[str] = []
        for dep in packages:
            if dep.startswith("pip:"):
                specs.append(dep[4:])
                continue
            name = re.split(r"[<>=!]", dep, 1)[0].strip()
            if name.lower() in cls._SKIP:
                continue
            m = re.fullmatch(r"([A-Za-z0-9._-]+)=([^=].*)", dep.strip())
            specs.append(f"{m.group(1)}=={m.group(2)}" if m else dep)
        return specs

    def _build_with_conda(self, conda: str, env_dir: str,
                          packages: List[str], timeout_s: float) -> None:
        import json

        if os.path.exists(env_dir):
            shutil.rmtree(env_dir, ignore_errors=True)
        os.makedirs(os.path.dirname(env_dir), exist_ok=True)
        deps: List[object] = []
        pip_deps: List[str] = []
        for dep in packages:
            if dep.startswith("pip:"):
                pip_deps.append(dep[4:])
            else:
                deps.append(dep)
        if pip_deps:
            deps.append({"pip": pip_deps})
        yml = os.path.join(os.path.dirname(env_dir),
                           os.path.basename(env_dir) + ".yml")
        # the environment-yml subset conda needs is valid JSON, and
        # JSON is valid YAML — no yaml dependency required
        with open(yml, "w") as f:
            json.dump({"dependencies": deps}, f)
        try:
            proc = subprocess.run(
                [conda, "env", "create", "-p", env_dir, "-f", yml,
                 "--yes"],
                capture_output=True, text=True, timeout=timeout_s)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"conda env create failed:\n{proc.stderr}")
        except BaseException:
            shutil.rmtree(env_dir, ignore_errors=True)
            raise
        finally:
            with contextlib.suppress(OSError):
                os.unlink(yml)


_DEFAULT_CONDA_ROOT = os.path.join(
    os.path.expanduser("~"), ".ray_tpu_torch", "runtime_env", "conda")
_default_conda: Optional[CondaEnvManager] = None


def default_conda_manager() -> CondaEnvManager:
    global _default_conda
    with _default_lock:
        if _default_conda is None:
            _default_conda = CondaEnvManager(
                cache_root=_DEFAULT_CONDA_ROOT)
        return _default_conda
