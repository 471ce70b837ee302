"""The port's runtime environments against the JAX package's, on the CPU.

The 15 scenarios of tests/test_runtime_env.py run on the port's runtime
(``init(device="cpu")``). Those that run tasks or actors run on both
packages, one runtime after the other, and their values are compared
equal; the manager scenarios compare the URIs both packages make for
the same input. ``normalize`` of the same specs gives equal dicts on
both packages, ``pymod://``, ``pip://`` and ``conda://`` URIs included
(a site directory is compared relative to its package's cache root).
Then the process tier's ``env_vars`` (tests/test_process_workers.py)
and the warm pool's reap of a runtime-env actor
(tests/test_worker_pool.py) on the port's pool.

Every cache the packages write (pip and conda envs, py_modules
archives) is rooted in the test's ``tmp_path``, and pip runs with
``PIP_NO_INDEX=1``: every package it installs is a wheel the test
builds. Every wait is bounded.
"""

import importlib
import os
import sys
import time

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_client import _end_jax_leftovers

# worker processes cannot import this test module: its functions ship by
# value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

SIDES = (("jax", ray_tpu), ("torch", ray_tpu_torch))


def _priv(core, name):
    return importlib.import_module(f"{core.__name__}._private.{name}")


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    """Each package's env and module caches under this test's tmp_path,
    and pip offline."""
    monkeypatch.setenv("PIP_NO_INDEX", "1")
    monkeypatch.setenv("RAY_TPU_PY_MODULES_CACHE", str(tmp_path / "pymod"))
    for side, core in SIDES:
        inst = _priv(core, "runtime_env_installer")
        monkeypatch.setattr(inst, "_default_manager", inst.PipEnvManager(
            cache_root=str(tmp_path / side / "pip")))
        monkeypatch.setattr(inst, "_default_conda", inst.CondaEnvManager(
            cache_root=str(tmp_path / side / "conda")))
        monkeypatch.setattr(_priv(core, "runtime_env"), "_install_cache", {})
        monkeypatch.setattr(_priv(core, "runtime_env_packaging"),
                            "_default", None)
    yield


def _on_both(scenario, **init_kwargs):
    """``scenario(core)`` on the JAX runtime, then on the port's -> the
    port's result, after asserting it equals the JAX one."""
    out = []
    for _, core in SIDES:
        kwargs = dict(num_cpus=8, **init_kwargs)
        if core is ray_tpu_torch:
            kwargs["device"] = "cpu"
        else:
            _end_jax_leftovers()
        core.init(**kwargs)
        try:
            out.append(scenario(core))
        finally:
            core.shutdown()
    assert out[1] == out[0]
    return out[1]


# ---------------------------------------------------------------- tasks


def test_env_vars_in_task():
    def scenario(core):
        @core.remote(runtime_env={"env_vars": {"RT_TEST_VAR": "42"}})
        def read_env():
            return os.environ.get("RT_TEST_VAR")

        got = core.get([read_env.remote()])[0]
        return got, os.environ.get("RT_TEST_VAR")  # restored after

    assert _on_both(scenario) == ("42", None)


def test_working_dir_in_task(tmp_path):
    def scenario(core):
        @core.remote(runtime_env={"working_dir": str(tmp_path)})
        def cwd():
            return os.getcwd()

        return core.get([cwd.remote()])[0]

    assert _on_both(scenario) == str(tmp_path)


def test_env_vars_in_actor_init():
    def scenario(core):
        @core.remote(runtime_env={"env_vars": {"RT_ACTOR_VAR": "actor"}})
        class A:
            def __init__(self):
                self.seen = os.environ.get("RT_ACTOR_VAR")

            def get(self):
                return self.seen

        a = A.remote()
        return core.get([a.get.remote()])[0]

    assert _on_both(scenario) == "actor"


def test_options_override():
    def scenario(core):
        @core.remote
        def read_env():
            return os.environ.get("RT_OPT_VAR")

        f = read_env.options(runtime_env={"env_vars": {"RT_OPT_VAR": "opt"}})
        return core.get([f.remote()])[0], core.get(read_env.remote())

    assert _on_both(scenario) == ("opt", None)


def test_validation():
    got = []
    for _, core in SIDES:
        env_mod = _priv(core, "runtime_env")
        with pytest.raises(ValueError):
            env_mod.RuntimeEnv(bogus_field=1)
        with pytest.raises(TypeError):
            env_mod.RuntimeEnv(env_vars={"A": 1})
        with pytest.raises(ValueError):
            env_mod.RuntimeEnv(working_dir="/does/not/exist")
        with pytest.raises(RuntimeError, match="not importable"):
            env_mod.normalize({"pip": ["definitely-not-installed-pkg-xyz"]})
        # already-importable pip packages validate fine
        env = env_mod.normalize({"pip": ["numpy"]})
        assert env is not None
        got.append(dict(env))
    assert got[1] == got[0] == {"pip": ["numpy"]}
    assert ray_tpu_torch._private.runtime_env.RuntimeEnv.KNOWN_FIELDS == \
        ray_tpu._private.runtime_env.RuntimeEnv.KNOWN_FIELDS


def test_py_modules(tmp_path):
    mod_dir = tmp_path / "mods"
    mod_dir.mkdir()
    (mod_dir / "rt_env_probe_mod.py").write_text("VALUE = 7\n")

    def scenario(core):
        @core.remote(runtime_env={"py_modules": [str(mod_dir)]})
        def load():
            import importlib

            import rt_env_probe_mod

            importlib.reload(rt_env_probe_mod)
            return rt_env_probe_mod.VALUE

        return core.get([load.remote()])[0]

    assert _on_both(scenario) == 7


# -------------------------------------------------------- pip installer


def _make_wheel(tmp_path, name="rtenv_probe_pkg", version="0.1",
                value=41):
    """A minimal wheel built offline: a zip with a dist-info."""
    import base64
    import hashlib
    import zipfile

    wheel_path = tmp_path / f"{name}-{version}-py3-none-any.whl"
    files = {
        f"{name}/__init__.py": f"VALUE = {value}\n",
        f"{name}-{version}.dist-info/METADATA": (
            f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n"),
        f"{name}-{version}.dist-info/WHEEL": (
            "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-Purelib: true\n"
            "Tag: py3-none-any\n"),
    }
    record_rows = []
    with zipfile.ZipFile(wheel_path, "w") as zf:
        for arc, content in files.items():
            data = content.encode()
            zf.writestr(arc, data)
            digest = base64.urlsafe_b64encode(
                hashlib.sha256(data).digest()).rstrip(b"=").decode()
            record_rows.append(f"{arc},sha256={digest},{len(data)}")
        record_rows.append(f"{name}-{version}.dist-info/RECORD,,")
        zf.writestr(f"{name}-{version}.dist-info/RECORD",
                    "\n".join(record_rows) + "\n")
    return wheel_path


def test_pip_env_manager_creates_and_caches(tmp_path):
    from ray_tpu._private.runtime_env_installer import (
        PipEnvManager as JaxPipEnvManager,
    )
    from ray_tpu_torch._private.runtime_env_installer import PipEnvManager

    wheel = _make_wheel(tmp_path)
    mgr = PipEnvManager(cache_root=str(tmp_path / "cache"))
    uri1, site1 = mgr.get_or_create([str(wheel)])
    assert (tmp_path / "cache").is_dir()
    assert os.path.isdir(os.path.join(site1, "rtenv_probe_pkg"))
    # same spec -> same env reused
    uri2, site2 = mgr.get_or_create([str(wheel)])
    assert uri1 == uri2 and site1 == site2
    assert uri1 == JaxPipEnvManager.uri_for([str(wheel)])


def test_pip_env_refcount_gc(tmp_path):
    from ray_tpu_torch._private.runtime_env_installer import PipEnvManager

    mgr = PipEnvManager(cache_root=str(tmp_path / "cache"),
                        max_cached_envs=1)
    w1 = _make_wheel(tmp_path, name="rtenv_gc_one", value=1)
    w2 = _make_wheel(tmp_path, name="rtenv_gc_two", value=2)
    uri1, site1 = mgr.get_or_create([str(w1)])
    mgr.acquire(uri1)
    uri2, site2 = mgr.get_or_create([str(w2)])
    mgr.acquire(uri2)
    # both alive: over capacity but refcounted -> no GC yet
    assert os.path.exists(site1) and os.path.exists(site2)
    mgr.release(uri2)
    # uri2 now zero-ref and the cache over capacity -> GC removed it;
    # uri1 is still referenced and survives
    assert not os.path.exists(site2)
    assert os.path.exists(site1)
    mgr.release(uri1)
    assert mgr.stats()["refcounts"] == {}


def test_pip_package_importable_inside_worker_process(tmp_path):
    """A pip runtime_env whose package this process cannot import
    installs for real and imports inside a worker process."""
    wheel = _make_wheel(tmp_path, name="rtenv_worker_pkg", value=77)
    with pytest.raises(ImportError):
        import rtenv_worker_pkg  # noqa: F401 — must not leak here

    ray_tpu_torch.init(num_cpus=2, worker_mode="process",
                       num_process_workers=1, device="cpu")
    try:
        @ray_tpu_torch.remote(runtime_env={"pip": [str(wheel)]})
        def probe():
            import rtenv_worker_pkg

            return rtenv_worker_pkg.VALUE

        assert ray_tpu_torch.get(probe.remote(), timeout=60) == 77
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------------------------ conda envs


def test_conda_env_materializes_offline(tmp_path):
    """A conda runtime_env whose package this process lacks materializes
    (offline pip translation on a host without conda) and imports
    inside a worker process."""
    wheel = _make_wheel(tmp_path, name="conda_probe_pkg", value=31)
    with pytest.raises(ImportError):
        import conda_probe_pkg  # noqa: F401 — must not leak

    ray_tpu_torch.init(num_cpus=2, worker_mode="process",
                       num_process_workers=1, device="cpu")
    try:
        spec = {"dependencies": ["python=3.12", {"pip": [str(wheel)]}]}

        @ray_tpu_torch.remote(runtime_env={"conda": spec})
        def probe():
            import conda_probe_pkg

            return conda_probe_pkg.VALUE

        assert ray_tpu_torch.get(probe.remote(), timeout=60) == 31
    finally:
        ray_tpu_torch.shutdown()


def test_conda_manager_uri_cache_and_pin_translation(tmp_path):
    from ray_tpu._private.runtime_env_installer import (
        CondaEnvManager as JaxCondaEnvManager,
    )
    from ray_tpu_torch._private.runtime_env_installer import CondaEnvManager

    wheel = _make_wheel(tmp_path, name="conda_cache_pkg", value=5)
    mgr = CondaEnvManager(cache_root=str(tmp_path / "conda_cache"))
    spec = {"dependencies": ["python=3.12", {"pip": [str(wheel)]}]}
    uri1, site1 = mgr.get_or_create_spec(spec)
    uri2, site2 = mgr.get_or_create_spec(spec)
    assert uri1 == uri2 and site1 == site2  # URI-cached, one build
    assert uri1.startswith("conda://")
    assert uri1 == JaxCondaEnvManager.uri_for(
        JaxCondaEnvManager.canonical_deps(spec))
    assert os.path.isdir(os.path.join(site1, "conda_cache_pkg"))
    deps = CondaEnvManager.canonical_deps(
        {"dependencies": ["numpy=1.26", "python=3.12"]})
    assert deps == ["numpy=1.26", "python=3.12"]


def test_conda_pin_translation_preserves_range_operators():
    pins = ["numpy=1.26", "scipy>=1.10", "pandas<=2.0", "torch>2",
            "jax==0.4.1", "python>=3.10", "pip:mypkg==1"]
    got = [_priv(core, "runtime_env_installer").CondaEnvManager
           .to_pip_specs(pins) for _, core in SIDES]
    assert got[1] == got[0] == ["numpy==1.26", "scipy>=1.10",
                                "pandas<=2.0", "torch>2", "jax==0.4.1",
                                "mypkg==1"]


# ------------------------------------------------------ py_modules URIs


def test_py_modules_packaged_to_uri_and_gc(tmp_path):
    """Local dirs package into content-addressed pymod:// URIs at submit,
    resolve to node-local extracts in workers, and GC by refcount and
    LRU."""
    from ray_tpu._private.runtime_env_packaging import (
        PyModulesManager as JaxPyModulesManager,
    )
    from ray_tpu_torch._private.runtime_env_packaging import (
        PyModulesManager,
    )

    mod_dir = tmp_path / "shipmods"
    mod_dir.mkdir()
    (mod_dir / "shipped_probe_mod.py").write_text("WHO = 'packaged'\n")

    def scenario(core):
        @core.remote(runtime_env={"py_modules": [str(mod_dir)]})
        def load():
            import importlib

            import shipped_probe_mod

            importlib.reload(shipped_probe_mod)
            return shipped_probe_mod.WHO

        return core.get(load.remote())

    assert _on_both(scenario) == "packaged"

    mgr = PyModulesManager(cache_root=str(tmp_path / "cache"),
                           max_cached=1)
    uri1 = mgr.package_dir(str(mod_dir))
    assert uri1.startswith("pymod://")
    assert mgr.package_dir(str(mod_dir)) == uri1  # content-addressed
    assert uri1 == JaxPyModulesManager(
        cache_root=str(tmp_path / "jcache")).package_dir(str(mod_dir))
    out = mgr.ensure_local(uri1)
    # the returned entry IS the module dir
    assert os.path.exists(os.path.join(out, "shipped_probe_mod.py"))
    (mod_dir / "shipped_probe_mod.py").write_text("WHO = 'v2'\n")
    uri2 = mgr.package_dir(str(mod_dir))
    assert uri2 != uri1  # content changed -> new uri
    mgr.acquire(uri2)
    mgr.ensure_local(uri2)
    # backdate uri1's ready-marker past the cross-process recency window
    marker = os.path.join(mgr._extract_dir(uri1), ".ready")
    old = os.path.getmtime(marker) - 3600
    os.utime(marker, (old, old))
    mgr._maybe_gc()
    # uri1 (zero-ref, LRU, idle) evicted; uri2 (held, fresh) survives
    assert not os.path.exists(mgr._extract_dir(uri1))
    assert os.path.exists(mgr._extract_dir(uri2))


def test_py_modules_kv_fetch_path(tmp_path):
    """A node that lacks the local archive fetches it through the
    runtime's KV (the remote-node path)."""
    from ray_tpu_torch._private.runtime_env_packaging import (
        KV_NAMESPACE,
        PyModulesManager,
    )
    from ray_tpu_torch.core import runtime as rt_mod

    mod_dir = tmp_path / "kvmods"
    mod_dir.mkdir()
    (mod_dir / "kv_mod.py").write_text("X = 1\n")
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        rt = rt_mod.global_runtime
        src = PyModulesManager(cache_root=str(tmp_path / "srccache"))
        uri = src.package_dir(str(mod_dir), kv_put=lambda k, v: rt.kv_put(
            KV_NAMESPACE, k, v))
        # a different node: fresh cache root, no archive on disk
        dst = PyModulesManager(cache_root=str(tmp_path / "dstcache"))
        out = dst.ensure_local(
            uri, fetch=lambda k: rt.kv_get(KV_NAMESPACE, k))
        assert os.path.exists(os.path.join(out, "kv_mod.py"))
        with pytest.raises(FileNotFoundError):
            dst.ensure_local("pymod://" + "0" * 40, fetch=lambda k: None)
    finally:
        ray_tpu_torch.shutdown()


def test_py_modules_cluster_tier_kv_staging(tmp_path):
    """The cluster tier end to end: py_modules packaged to the GCS KV at
    submit; a raylet whose host cache lacks the archive (the cache is
    cleared, as on a remote node) stages it through its GCS client
    before dispatch, and the worker imports the module."""
    import shutil

    from ray_tpu_torch._private import runtime_env_packaging as pkg
    from ray_tpu_torch.cluster.process_cluster import (
        ClusterClient,
        ProcessCluster,
    )

    mod_dir = tmp_path / "clustermods"
    mod_dir.mkdir()
    (mod_dir / "cluster_shipped.py").write_text("TIER = 'process'\n")
    cluster = ProcessCluster(heartbeat_period_ms=200,
                             num_heartbeats_timeout=40, gcs_device="cpu")
    try:
        cluster.add_node(num_cpus=2, object_store_memory=64 << 20)
        cluster.wait_for_nodes(1)
        client = ClusterClient(cluster.gcs_address)
        try:
            uri = pkg.default_py_modules_manager().package_dir(
                str(mod_dir), kv_put=lambda k, v: client.kv_put(
                    k, v, ns=pkg.KV_NAMESPACE))
            shutil.rmtree(pkg.default_py_modules_manager().cache_root,
                          ignore_errors=True)

            def load():
                import importlib

                import cluster_shipped

                importlib.reload(cluster_shipped)
                return cluster_shipped.TIER

            ref = client.submit(load, runtime_env={"py_modules": [uri]})
            assert client.get(ref, timeout=60.0) == "process"
            # the raylet fetched the archive back into the host cache
            assert os.path.exists(
                pkg.default_py_modules_manager()._archive_path(uri))
        finally:
            client.close()
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------- parity


def _normalized(core, spec):
    env_mod = _priv(core, "runtime_env")
    inst = _priv(core, "runtime_env_installer")
    env = dict(env_mod.normalize(spec))
    # a site dir lives under its package's own cache root
    roots = {"pip_site": inst.default_manager().cache_root,
             "conda_site": inst.default_conda_manager().cache_root}
    for key, root in roots.items():
        if key in env:
            env[key] = os.path.relpath(env[key], root)
    return env


def test_normalize_equal_on_both_packages(tmp_path):
    mod_dir = tmp_path / "parity_mods"
    mod_dir.mkdir()
    (mod_dir / "parity_mod.py").write_text("P = 1\n")
    (mod_dir / "sub").mkdir()
    (mod_dir / "sub" / "data.txt").write_text("payload\n")
    wheel = _make_wheel(tmp_path, name="rtenv_parity_pkg", value=3)
    specs = [
        {"env_vars": {"A": "1", "B": "two"}},
        {"working_dir": str(tmp_path)},
        {"py_modules": [str(mod_dir), "/plain/path.py",
                        "pymod://" + "a" * 40]},
        {"pip": [str(wheel)]},
        {"conda": {"dependencies": ["python=3.12", {"pip": [str(wheel)]}]}},
        {"env_vars": {"C": "3"}, "config": {"setup_timeout_seconds": 5}},
    ]
    for spec in specs:
        jax_env = _normalized(ray_tpu, spec)
        port_env = _normalized(ray_tpu_torch, spec)
        assert port_env == jax_env, spec
    uri = _normalized(ray_tpu_torch, specs[2])["py_modules"][0]
    assert uri.startswith("pymod://") and len(uri) == len("pymod://") + 40
    for _, core in SIDES:
        assert _priv(core, "runtime_env").normalize(None) is None
        with pytest.raises(TypeError):
            _priv(core, "runtime_env").normalize(["env_vars"])


def test_same_env_seen_inside_a_task(tmp_path):
    """env_vars, working_dir and a packaged module, together, read inside
    one task of each package."""
    mod_dir = tmp_path / "seen_mods"
    mod_dir.mkdir()
    (mod_dir / "seen_probe.py").write_text("TAG = 'seen'\n")
    env = {"env_vars": {"RT_SEEN_A": "a", "RT_SEEN_B": "b"},
           "working_dir": str(tmp_path),
           "py_modules": [str(mod_dir)]}

    def scenario(core):
        @core.remote(runtime_env=env)
        def look():
            import importlib

            import seen_probe

            importlib.reload(seen_probe)
            return (os.environ.get("RT_SEEN_A"), os.environ.get("RT_SEEN_B"),
                    os.getcwd(), seen_probe.TAG)

        return core.get(look.remote()), os.environ.get("RT_SEEN_A")

    assert _on_both(scenario) == (("a", "b", str(tmp_path), "seen"), None)


# ---------------------------------------------------- process tier, pool


def test_runtime_env_env_vars_in_process_worker():
    """tests/test_process_workers.py's env_vars scenario on the port's
    process tier: the env applies inside the worker process, and an
    actor's env holds for the actor's life."""
    ray_tpu_torch.init(num_cpus=4, worker_mode="process",
                       num_process_workers=2, device="cpu")
    try:
        @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_FLAG": "on"}})
        def read_flag():
            return os.environ.get("MY_FLAG"), os.getpid()

        @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_FLAG": "actor"}})
        class Reader:
            def read(self):
                return os.environ.get("MY_FLAG")

        flag, pid = ray_tpu_torch.get(read_flag.remote(), timeout=60)
        assert (flag, pid != os.getpid()) == ("on", True)
        reader = Reader.remote()
        assert ray_tpu_torch.get([reader.read.remote() for _ in range(2)],
                                 timeout=60) == ["actor", "actor"]
        assert os.environ.get("MY_FLAG") is None
    finally:
        ray_tpu_torch.shutdown()


class Echo:
    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value


def test_pool_level_runtime_env_actor_is_reaped():
    """tests/test_worker_pool.py's scenario on the port's pool: a
    runtime_env held for the actor's life marks the worker dirty, so
    kill reaps the process instead of returning it to the warm pool."""
    from ray_tpu_torch._private.runtime_env import normalize
    from ray_tpu_torch.cluster.process_pool import ProcessWorkerPool

    pool = ProcessWorkerPool(size=1, warm_size=1)
    try:
        deadline = time.monotonic() + 30
        while pool.stats()["warm_idle"] < 1:
            assert time.monotonic() < deadline, "warm pool never filled"
            time.sleep(0.05)
        env = normalize({"env_vars": {"POOL_DIRTY_FLAG": "on"}})
        proxy = pool.create_actor_process(Echo, (3,), {}, runtime_env=env)
        assert proxy.get() == 3
        pid = proxy.__ray_proxy_pid__()
        proxy.__ray_on_kill__()
        stats = pool.stats()
        assert stats["warm_reaped"] >= 1
        assert stats["warm_returned"] == 0
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
                time.sleep(0.05)
            except ProcessLookupError:
                break
        else:
            pytest.fail("dirty worker was not reaped")
    finally:
        pool.shutdown()
