"""Runtime environments — per-task/actor execution context.

Reference: python/ray/_private/runtime_env/ (env_vars, working_dir,
py_modules, pip/conda) created lazily by the per-node agent and
refcounted by URI. Fields:

  - env_vars: applied around the task/actor body (and restored after)
  - working_dir: recorded + chdir'd around the body
  - pip: REAL venv creation via _private/runtime_env_installer.py
    (URI-cached, refcounted GC); the env's site-packages joins sys.path
    around the body and PYTHONPATH for worker processes. Specs needing
    the network fail at creation unless already importable (graceful
    fallback for pre-baked packages in this zero-egress environment).
  - py_modules: local DIRS are packaged at submit (zipped,
    content-addressed pymod:// URI, seeded to the node cache + cluster
    KV — _private/runtime_env_packaging.py, reference py_modules.py);
    workers resolve URIs to extracted dirs on sys.path. Plain paths
    and pre-packaged URIs pass through.
  - conda: REAL env materialization via CondaEnvManager
    (runtime_env_installer.py): `conda env create` when a conda binary
    exists, else offline pip --target translation of the dependency
    list — URI-cached and refcounted like pip (reference conda.py).
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys
import threading
from typing import Any, Dict, List, Optional

_env_lock = threading.Lock()  # env vars are process-global


def _requirement_name(spec: str) -> str:
    """Base importable name of a pip requirement: everything before the
    first version operator (==, >=, <=, <, >, !=, ~=) or extras
    marker."""
    import re

    return re.split(r"[<>=!~\[;@ ]", spec.strip(), 1)[0]
# spec-URI -> ("ok", site) | "fallback"; avoids re-running venv/pip
# subprocesses for specs normalize() sees on every submit
_install_cache: Dict[str, Any] = {}
_install_cache_lock = threading.Lock()


class RuntimeEnv(dict):
    """Validated runtime environment description."""

    KNOWN_FIELDS = {"env_vars", "working_dir", "py_modules", "pip",
                    "conda", "config"}

    def __init__(self, **kwargs):
        unknown = set(kwargs) - self.KNOWN_FIELDS
        if unknown:
            raise ValueError(f"unknown runtime_env field(s): {unknown}")
        env_vars = kwargs.get("env_vars") or {}
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in env_vars.items()):
            raise TypeError("env_vars must be Dict[str, str]")
        wd = kwargs.get("working_dir")
        if wd is not None and not os.path.isdir(wd):
            raise ValueError(f"working_dir does not exist: {wd}")
        super().__init__(**{k: v for k, v in kwargs.items()
                            if v is not None})

    def validate_installable(self) -> None:
        """Materialize the pip field: create (or reuse) the venv now so
        failures surface at submission, not mid-task (the reference
        creates envs at first use on the node agent; eager here keeps
        error locality). Records the env's site dir + URI in self.

        Outcomes are cached per spec URI — normalize() runs on every
        submit, and a spec that cannot install (zero-egress) must not
        re-run venv + pip subprocesses per .remote() call."""
        self._materialize_conda()
        self._package_py_modules(kv_put=self.pop("_kv_put", None))
        packages = self.get("pip") or []
        if not packages or "pip_site" in self:
            return
        from ray_tpu_torch._private.runtime_env_installer import default_manager

        uri = default_manager().uri_for(list(packages))
        with _install_cache_lock:
            cached = _install_cache.get(uri)
        if cached == "fallback":
            return  # importability already verified once
        if isinstance(cached, tuple) and os.path.isdir(cached[1]):
            # ("ok", site) — and the env still exists (GC may have
            # reclaimed it; fall through to rebuild if so)
            self["pip_uri"] = uri
            self["pip_site"] = cached[1]
            return
        try:
            uri, site = default_manager().get_or_create(list(packages))
            self["pip_uri"] = uri
            self["pip_site"] = site
            with _install_cache_lock:
                _install_cache[uri] = ("ok", site)
            return
        except Exception as install_err:
            # zero-egress fallback: accept if everything is already
            # importable in this interpreter
            for pkg in packages:
                base = _requirement_name(pkg)
                try:
                    importlib.import_module(base.replace("-", "_"))
                except ImportError:
                    raise RuntimeError(
                        f"runtime_env pip install failed and package "
                        f"{pkg!r} is not importable: {install_err}"
                    ) from install_err
            with _install_cache_lock:
                _install_cache[uri] = "fallback"

    def _materialize_conda(self) -> None:
        """Create (or reuse) the conda env now, like the pip path —
        real `conda env create` with a conda binary, offline pip
        translation without one (zero-egress image)."""
        spec = self.get("conda")
        if not spec or "conda_site" in self:
            return
        from ray_tpu_torch._private.runtime_env_installer import (
            CondaEnvManager,
            default_conda_manager,
        )

        deps = CondaEnvManager.canonical_deps(spec)
        uri = CondaEnvManager.uri_for(deps)
        with _install_cache_lock:
            cached = _install_cache.get(uri)
        if cached == "fallback":
            return  # importability already verified once
        if isinstance(cached, tuple) and os.path.isdir(cached[1]):
            self["conda_uri"], self["conda_site"] = uri, cached[1]
            return
        try:
            uri, site = default_conda_manager().get_or_create_spec(spec)
        except Exception as install_err:
            # same zero-egress fallback + failure caching discipline as
            # the pip path: accept when everything is already
            # importable, and never re-run the build subprocesses per
            # .remote() call for a spec that cannot install
            import importlib as _importlib

            for pip_spec in CondaEnvManager.to_pip_specs(deps):
                base = _requirement_name(pip_spec)
                try:
                    _importlib.import_module(base.replace("-", "_"))
                except ImportError:
                    raise RuntimeError(
                        f"runtime_env conda materialization failed and "
                        f"dependency {pip_spec!r} is not importable: "
                        f"{install_err}") from install_err
            with _install_cache_lock:
                _install_cache[uri] = "fallback"
            return
        self["conda_uri"] = uri
        self["conda_site"] = site
        with _install_cache_lock:
            _install_cache[uri] = ("ok", site)

    def _package_py_modules(self, kv_put=None) -> None:
        """Local module DIRS become content-addressed pymod:// URIs at
        submit (reference py_modules.py packaging); plain file paths
        and existing URIs pass through unchanged. ``kv_put`` injects the
        submitting tier's KV writer (ClusterClient passes the GCS KV —
        the store the raylet staging fetch reads); the in-process
        runtime's KV is the default."""
        mods = self.get("py_modules")
        if not mods or self.get("_py_modules_packaged"):
            return
        from ray_tpu_torch._private.runtime_env_packaging import (
            cluster_kv_put,
            default_py_modules_manager,
        )

        manager = default_py_modules_manager()
        kv_put = kv_put or cluster_kv_put()
        out = []
        for entry in mods:
            if isinstance(entry, str) and os.path.isdir(entry):
                out.append(manager.package_dir(entry, kv_put))
            else:
                out.append(entry)
        self["py_modules"] = out
        self["_py_modules_packaged"] = True

    def reseed_py_modules_kv(self, kv_put) -> None:
        """Upload this env's already-packaged pymod:// archives (from
        the node-local cache) into another tier's KV, so resubmission
        through that tier serves remote nodes too."""
        from ray_tpu_torch._private.runtime_env_packaging import (
            default_py_modules_manager,
        )

        manager = default_py_modules_manager()
        for entry in self.get("py_modules") or []:
            if not (isinstance(entry, str)
                    and entry.startswith("pymod://")):
                continue
            archive = manager._archive_path(entry)
            try:
                with open(archive, "rb") as f:
                    kv_put(entry.encode(), f.read())
            except OSError:
                pass  # archive evicted locally; the origin KV may serve

    def acquire(self) -> None:
        """Refcount the env's URIs for the duration of a task/actor."""
        from ray_tpu_torch._private.runtime_env_installer import (
            default_conda_manager,
            default_manager,
        )
        from ray_tpu_torch._private.runtime_env_packaging import (
            default_py_modules_manager,
        )

        if self.get("pip_uri"):
            default_manager().acquire(self["pip_uri"])
        if self.get("conda_uri"):
            default_conda_manager().acquire(self["conda_uri"])
        for entry in self.get("py_modules") or []:
            if isinstance(entry, str) and entry.startswith("pymod://"):
                default_py_modules_manager().acquire(entry)

    def release(self) -> None:
        from ray_tpu_torch._private.runtime_env_installer import (
            default_conda_manager,
            default_manager,
        )
        from ray_tpu_torch._private.runtime_env_packaging import (
            default_py_modules_manager,
        )

        if self.get("pip_uri"):
            default_manager().release(self["pip_uri"])
        if self.get("conda_uri"):
            default_conda_manager().release(self["conda_uri"])
        for entry in self.get("py_modules") or []:
            if isinstance(entry, str) and entry.startswith("pymod://"):
                default_py_modules_manager().release(entry)

    @contextlib.contextmanager
    def applied(self):
        """Apply env_vars + working_dir + pip/py_modules paths around a
        task body. The pip env's site dir also joins PYTHONPATH so any
        child process the task forks inherits it (the reference starts
        workers inside the env's interpreter; path injection is the
        in-process analogue)."""
        env_vars: Dict[str, str] = dict(self.get("env_vars") or {})
        wd: Optional[str] = self.get("working_dir")
        py_modules: List[str] = []
        for entry in self.get("py_modules") or []:
            if isinstance(entry, str) and entry.startswith("pymod://"):
                # packaged module: resolve to the node-local extract
                # (fetching through the cluster KV when not cached)
                from ray_tpu_torch._private.runtime_env_packaging import (
                    cluster_kv_get,
                    default_py_modules_manager,
                )

                py_modules.append(
                    default_py_modules_manager().ensure_local(
                        entry, fetch=cluster_kv_get()))
            else:
                py_modules.append(entry)
        sites = [s for s in (self.get("pip_site"),
                             self.get("conda_site")) if s]
        for site in reversed(sites):
            py_modules.insert(0, site)
        if sites:
            existing = os.environ.get("PYTHONPATH", "")
            env_vars.setdefault(
                "PYTHONPATH",
                os.pathsep.join(sites)
                + (os.pathsep + existing if existing else ""))
        with _env_lock:
            saved_env = {k: os.environ.get(k) for k in env_vars}
            os.environ.update(env_vars)
            saved_cwd = os.getcwd() if wd else None
            if wd:
                os.chdir(wd)
            added_paths = []
            for p in py_modules:
                if p not in sys.path:
                    sys.path.insert(0, p)
                    added_paths.append(p)
        try:
            yield
        finally:
            with _env_lock:
                for k, old in saved_env.items():
                    if old is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = old
                if saved_cwd:
                    os.chdir(saved_cwd)
                for p in added_paths:
                    with contextlib.suppress(ValueError):
                        sys.path.remove(p)


def normalize(runtime_env, kv_put=None) -> Optional[RuntimeEnv]:
    if runtime_env is None:
        return None
    if isinstance(runtime_env, RuntimeEnv):
        if kv_put is not None:
            # an already-normalized env resubmitted through a tier with
            # its own KV must not silently leave its archives in the
            # previous tier's store: package anything unpackaged AND
            # re-seed already-packaged archives into THIS tier's KV
            if not runtime_env.get("_py_modules_packaged"):
                runtime_env["_kv_put"] = kv_put
                runtime_env.validate_installable()
            else:
                runtime_env.reseed_py_modules_kv(kv_put)
        return runtime_env
    if isinstance(runtime_env, dict):
        env = RuntimeEnv(**runtime_env)
        if kv_put is not None:
            env["_kv_put"] = kv_put  # consumed by validate_installable
        env.validate_installable()
        return env
    raise TypeError(f"runtime_env must be a dict, got {type(runtime_env)}")
