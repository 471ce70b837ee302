"""The port's process worker tier (ray_tpu_torch/cluster/) on the CPU: the
twin of tests/test_process_workers.py, on ``init(device="cpu",
worker_mode="process")``, with the same inputs and expected results.

Reference parity targets: worker_pool.h process forking + reuse,
plasma-style shm payload transport, worker-crash retry, actor-per-process
with restart on process death, a runtime_env applied inside the worker
process. Where the port differs it says so: its device rule is CUDA's (a
worker sees no card unless RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES names
one) where the JAX package forces JAX onto the CPU. Every wait is
bounded.
"""

import os
import signal
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import WorkerCrashedError

# worker processes cannot import this test module (it lives outside the
# package): its functions and classes ship by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

GET_TIMEOUT_S = 60


def _get(refs, timeout=GET_TIMEOUT_S):
    return ray_tpu_torch.get(refs, timeout=timeout)


@pytest.fixture
def proc_runtime():
    rt = ray_tpu_torch.init(num_cpus=4, worker_mode="process",
                            num_process_workers=2, device="cpu")
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def _wait_gone(pid, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.1)
    return False


def test_task_runs_in_separate_process(proc_runtime):
    @ray_tpu_torch.remote
    def whoami():
        return os.getpid()

    pid = _get(whoami.remote())
    assert pid != os.getpid()
    assert pid in proc_runtime.process_pool.pids()


def test_worker_process_reuse(proc_runtime):
    @ray_tpu_torch.remote
    def whoami():
        return os.getpid()

    pids = set(_get([whoami.remote() for _ in range(8)]))
    # 8 tasks over a 2-process pool: processes are reused, not forked
    assert pids <= set(proc_runtime.process_pool.pids())
    assert len(pids) <= 2


def test_numpy_round_trip_via_shm(proc_runtime):
    arr = np.arange(200_000, dtype=np.float32)  # > SHM_THRESHOLD

    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    out = _get(double.remote(arr))
    np.testing.assert_array_equal(out, arr * 2)
    # the pool rides the port's own native segment
    assert proc_runtime.process_pool.shm_path
    assert proc_runtime.process_pool.shm_path == \
        proc_runtime._process_shm.path


def test_large_inline_frame_round_trip(proc_runtime):
    # strings pickle inline (no out-of-band buffer): a 1 MB string forces
    # multi-chunk pipe frames both ways, the short-read case
    payload = "x" * (1 << 20)

    @ray_tpu_torch.remote
    def echo(s):
        return s + "y"

    assert _get(echo.remote(payload)) == payload + "y"


def test_kill_busy_actor_does_not_hang(proc_runtime):
    @ray_tpu_torch.remote
    class Spinner:
        def getpid(self):
            return os.getpid()

        def spin(self):
            while True:
                time.sleep(0.1)

    s = Spinner.remote()
    pid = _get(s.getpid.remote())
    s.spin.remote()  # occupies the actor process indefinitely
    time.sleep(0.5)
    start = time.monotonic()
    ray_tpu_torch.kill(s)  # must SIGKILL the busy process, not wait
    assert time.monotonic() - start < 5
    assert _wait_gone(pid), "busy actor process survived kill"


def test_exception_propagates_with_type(proc_runtime):
    class CustomError(ValueError):
        pass

    @ray_tpu_torch.remote
    def boom():
        raise CustomError("nope")

    with pytest.raises(ValueError, match="nope"):
        _get(boom.remote())


def test_worker_crash_retries_on_fresh_process(proc_runtime, tmp_path):
    marker = str(tmp_path / "crashed_once")

    @ray_tpu_torch.remote(max_retries=2)
    def die_once(path):
        if not os.path.exists(path):
            open(path, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return "recovered"

    assert _get(die_once.remote(marker), timeout=30) == "recovered"


def test_worker_crash_without_retries_errors(proc_runtime):
    @ray_tpu_torch.remote(max_retries=0)
    def die():
        os.kill(os.getpid(), signal.SIGKILL)

    with pytest.raises(WorkerCrashedError):
        _get(die.remote(), timeout=30)


def test_pool_replaces_dead_workers(proc_runtime):
    @ray_tpu_torch.remote(max_retries=0)
    def die():
        os.kill(os.getpid(), signal.SIGKILL)

    @ray_tpu_torch.remote
    def ok():
        return 42

    with pytest.raises(WorkerCrashedError):
        _get(die.remote(), timeout=30)
    # the pool spawned a replacement; later tasks still run
    assert _get(ok.remote()) == 42
    assert proc_runtime.process_pool.stats()["alive"] == 2


def test_actor_lives_in_own_process(proc_runtime):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0
            self.pid = os.getpid()

        def incr(self):
            self.n += 1
            return self.n

        def getpid(self):
            return self.pid

    c = Counter.remote()
    assert _get(c.incr.remote()) == 1
    assert _get(c.incr.remote()) == 2
    actor_pid = _get(c.getpid.remote())
    assert actor_pid != os.getpid()
    # actors get dedicated processes, not pool members
    assert actor_pid not in proc_runtime.process_pool.pids()


def test_actor_process_killed_restarts_with_budget(proc_runtime):
    @ray_tpu_torch.remote(max_restarts=1, max_task_retries=1)
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def getpid(self):
            return os.getpid()

    c = Counter.remote()
    assert _get(c.incr.remote()) == 1
    pid = _get(c.getpid.remote())
    os.kill(pid, signal.SIGKILL)
    # the next call finds the dead process, restarts the actor (fresh
    # __init__) and retries the call on the new process
    n = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            n = _get(c.incr.remote(), timeout=30)
            break
        except Exception:
            time.sleep(0.2)
    assert n == 1  # fresh state after restart
    assert _get(c.getpid.remote()) != pid


def test_actor_process_killed_no_budget_dies(proc_runtime):
    from ray_tpu_torch.exceptions import ActorDiedError, RayActorError

    @ray_tpu_torch.remote(max_restarts=0)
    class A:
        def getpid(self):
            return os.getpid()

    a = A.remote()
    pid = _get(a.getpid.remote())
    os.kill(pid, signal.SIGKILL)
    with pytest.raises((ActorDiedError, RayActorError)):
        _get(a.getpid.remote(), timeout=30)


def test_runtime_env_env_vars_in_process(proc_runtime):
    """runtime_env={"env_vars": ...} is applied inside the worker
    process, as the JAX package applies it."""
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_FLAG": "on"}})
    def read_flag():
        return os.environ.get("MY_FLAG")

    assert _get(read_flag.remote()) == "on"


def test_kill_actor_terminates_process(proc_runtime):
    @ray_tpu_torch.remote
    class A:
        def getpid(self):
            return os.getpid()

    a = A.remote()
    pid = _get(a.getpid.remote())
    ray_tpu_torch.kill(a)
    assert _wait_gone(pid), "actor process still alive after kill"


def test_shutdown_reaps_all_processes():
    rt = ray_tpu_torch.init(num_cpus=2, worker_mode="process",
                            num_process_workers=2, device="cpu")
    try:
        pids = rt.process_pool.pids()
        assert len(pids) == 2
    finally:
        ray_tpu_torch.shutdown()
    leaked = [p for p in pids if not _wait_gone(p)]
    assert not leaked, f"leaked worker processes: {leaked}"


def _hook_and_user_dirs(tmp_path, monkeypatch):
    """An accelerator site hook dir and a benign user-code dir on
    PYTHONPATH, as tests/test_process_workers.py builds them."""
    hook_dir = tmp_path / "hookdir"
    hook_dir.mkdir()
    (hook_dir / "sitecustomize.py").write_text(
        "# registers a jax accelerator plugin (sentinel for stripping)\n"
        "import os; os.environ['FAKE_TPU_HOOK_RAN'] = '1'\n")
    user_dir = tmp_path / "userdir"
    user_dir.mkdir()
    (user_dir / "my_worker_lib.py").write_text("VALUE = 37\n")
    monkeypatch.setenv(
        "PYTHONPATH",
        os.pathsep.join([str(hook_dir), str(user_dir),
                         os.environ.get("PYTHONPATH", "")]))


def _device_view():
    import os

    import torch

    import my_worker_lib  # the user dir survived the strip

    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch.cuda.device_count(), my_worker_lib.VALUE,
            os.environ.get("FAKE_TPU_HOOK_RAN"))


def test_worker_processes_see_no_card(tmp_path, monkeypatch):
    """The device rule: a worker never owns the parent's card. Its
    CUDA_VISIBLE_DEVICES is empty (so torch sees no device and the port's
    CUDA entry points raise) even when an accelerator site hook sits on
    PYTHONPATH and the parent names a device; the hook dir is stripped
    and user PYTHONPATH dirs without hooks survive."""
    _hook_and_user_dirs(tmp_path, monkeypatch)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.delenv("RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES", raising=False)
    ray_tpu_torch.init(num_cpus=2, worker_mode="process",
                       num_process_workers=1, device="cpu")
    try:
        visible, count, lib_value, hook_ran = _get(
            ray_tpu_torch.remote(_device_view).remote())
    finally:
        ray_tpu_torch.shutdown()
    assert visible == ""
    assert count == 0
    assert lib_value == 37          # benign PYTHONPATH entry kept
    assert hook_ran is None         # accelerator hook dir stripped


def test_worker_cuda_override_names_the_devices(tmp_path, monkeypatch):
    """RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES names the devices workers may
    see (the counterpart of the JAX package's
    RAY_TPU_WORKER_JAX_PLATFORMS): the worker's CUDA_VISIBLE_DEVICES is
    that value, for task workers and actor processes alike."""
    _hook_and_user_dirs(tmp_path, monkeypatch)
    monkeypatch.setenv("RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES", "3")
    ray_tpu_torch.init(num_cpus=2, worker_mode="process",
                       num_process_workers=1, device="cpu")
    try:
        task_view = _get(ray_tpu_torch.remote(_device_view).remote())

        @ray_tpu_torch.remote
        class Viewer:
            def view(self):
                return _device_view()

        actor_view = _get(Viewer.remote().view.remote())
    finally:
        ray_tpu_torch.shutdown()
    for visible, _, lib_value, hook_ran in (task_view, actor_view):
        assert visible == "3"
        assert lib_value == 37
        assert hook_ran is None


@pytest.mark.parametrize("worker, visible, want", [
    ("1", "", "cpu"),      # a worker the device rule left without a card
    ("1", "0", None),      # a worker the override gave a card
    (None, "", None),      # a driver: CUDA, and init raises without it
    (None, None, None),
])
def test_auto_init_device_rule(monkeypatch, worker, visible, want):
    """A runtime that starts without ``init`` runs on the CPU only in a
    process-tier worker that sees no card; anywhere else on CUDA."""
    from ray_tpu_torch._private.device import auto_init_device

    for name, value in (("RAY_TPU_WORKER_PROCESS", worker),
                        ("CUDA_VISIBLE_DEVICES", visible)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert auto_init_device() == want
