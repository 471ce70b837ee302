"""Dask-on-ray_tpu_torch scheduler shim.

Reference: python/ray/util/dask/ — a dask ``get`` scheduler that runs
each dask-graph task as a Ray task, so ``dask.compute(...,
scheduler=ray_dask_get)`` executes on the cluster with inter-task
data flowing through the object store.

A dask graph is plain data (the library is NOT required here): a dict
mapping keys to computations, where a computation is

    (callable, arg, ...)   a task; args may be keys, literals, or
                           nested task tuples
    key                    an alias of another graph entry
    literal                a constant

``ray_dask_get(dsk, keys)`` matches dask's scheduler ``get`` contract
(dask/core.py get): pass it to ``dask.compute``/``.compute(scheduler=
ray_dask_get)`` when dask is installed; the test suite drives it with
raw graph dicts since this image ships no dask.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

import ray_tpu_torch

_exec_remote = None


def _executor():
    """Lazy: ray_tpu_torch.remote at import time would bind before init."""
    global _exec_remote
    if _exec_remote is None:
        @ray_tpu_torch.remote
        def _dask_node(func, spec, *dep_values):
            # deps arrive positionally; rebuild the arg structure with
            # nested sub-tasks evaluated locally
            env = dict(zip(spec, dep_values))

            def rebuild(a):
                if isinstance(a, tuple) and a and callable(a[0]):
                    return a[0](*[rebuild(x) for x in a[1:]])
                if isinstance(a, list):
                    return [rebuild(x) for x in a]
                try:
                    if a in env:  # tuple keys may hold unhashables
                        return env[a]
                except TypeError:
                    pass
                return a

            return func(*[rebuild(a) for a in spec["__args__"]])

        _exec_remote = _dask_node
    return _exec_remote


def _task_deps(comp: Any, dsk: Dict) -> List[Hashable]:
    """Keys of ``dsk`` referenced anywhere inside a computation."""
    deps: List[Hashable] = []

    def walk(a):
        if isinstance(a, tuple) and a and callable(a[0]):
            for x in a[1:]:
                walk(x)
        elif isinstance(a, list):
            for x in a:
                walk(x)
        else:
            try:
                if a in dsk:
                    deps.append(a)
            except TypeError:
                pass

    if isinstance(comp, tuple) and comp and callable(comp[0]):
        for a in comp[1:]:
            walk(a)
    else:
        try:
            if comp in dsk:
                deps.append(comp)
        except TypeError:
            pass
    return deps


def ray_dask_get(dsk: Dict, keys, **kwargs):
    """Execute a dask graph on the cluster; returns values matching the
    (possibly nested) structure of ``keys``."""
    refs: Dict[Hashable, Any] = {}

    def schedule(key) -> Any:
        if key in refs:
            return refs[key]
        comp = dsk[key]
        if isinstance(comp, tuple) and comp and callable(comp[0]):
            dep_keys = _task_deps(comp, dsk)
            dep_refs = [schedule(k) for k in dep_keys]
            spec = {k: None for k in dep_keys}
            spec["__args__"] = list(comp[1:])
            ref = _executor().remote(comp[0], spec, *dep_refs)
        else:
            is_alias = False
            try:
                is_alias = comp in dsk
            except TypeError:
                pass
            ref = schedule(comp) if is_alias else ray_tpu_torch.put(comp)
        refs[key] = ref
        return ref

    def resolve(ks):
        if isinstance(ks, list):
            return [resolve(k) for k in ks]
        return ray_tpu_torch.get(schedule(ks))

    return resolve(keys)
