"""Parent-side management of worker processes.

``WorkerProcess``     — one child (Popen) + framed pipe protocol.
``ProcessWorkerPool`` — leased pool for normal tasks (reference:
                        worker_pool.h:144 PopWorker/PushWorker; idle
                        workers are reused, dead ones replaced).
``ActorProcess``      — dedicated child owning a live actor instance
                        (the reference starts one worker process per
                        actor; calls bypass the raylet and go straight
                        to it, transport/direct_actor_transport).

With ``warm_size > 0`` the pool additionally keeps that many IDLE
pre-forked workers (reference: worker_pool.cc prestart /
num_initial_python_workers): ``create_actor_process`` leases one
instantly and specializes it in place by shipping ``actor_create``
over the already-open pipe — interpreter boot and imports were paid
before the lease. A background replenisher (ThreadRegistry-owned)
refills after every lease; an empty pool falls back to the cold fork.
On kill, a worker whose actor left no process-global residue returns
to the pool (``actor_reset``); a dirty or busy one is reaped.

Death detection: any pipe error while a task is in flight surfaces as
``WorkerCrashedError`` carrying the pid — the owner-side signal that
drives retries and actor restarts, like the reference's disconnect
handling in NodeManager::HandleUnexpectedWorkerFailure.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.cluster import protocol
from ray_tpu_torch.exceptions import WorkerCrashedError

logger = logging.getLogger(__name__)


class WorkerBusyError(Exception):
    """A non-blocking pipe call found an in-flight call holding the
    worker's lock (warm-pool return path only)."""


class WorkerProcess:
    """One OS worker process plus its control pipes.

    With ``log_callback`` set, the child's stderr (where its print()s and
    tracebacks land — stdout is the framed reply pipe) is captured and
    fed line-by-line to the callback, the seam the reference's log
    monitor tails worker logs through (python/ray/_private/log_monitor.py).
    """

    def __init__(self, shm_path: str = "", log_callback=None,
                 preimport: str = ""):
        from ray_tpu_torch.cluster.child_env import sanitized_env

        self.shm_path = shm_path
        # workers never own the parent's accelerator and must not run
        # eager accelerator site hooks (see cluster/child_env.py); user
        # PYTHONPATH entries survive so their code imports in workers
        env = sanitized_env(pin_pythonpath=False)
        argv = [sys.executable, "-m", "ray_tpu_torch.cluster.worker_main",
                "--shm", shm_path,
                "--protocol-version", str(protocol.PIPE_PROTOCOL_VERSION)]
        if preimport:
            argv += ["--preimport", preimport]
        self._proc = subprocess.Popen(
            argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE if log_callback else None,
            env=env,
            text=False,
        )
        if log_callback is not None:
            # raycheck: disable=RC09 — stderr drain lives exactly as long as the worker child process: it exits on pipe EOF when the child dies, so the process (not a registry) is its teardown
            threading.Thread(
                target=self._drain_stderr, args=(log_callback,),
                daemon=True, name=f"worker-log-{self._proc.pid}").start()
        self._lock = threading.Lock()
        self._shm = None
        if shm_path:
            try:
                from ray_tpu_torch._native.shm_store import ShmStore

                self._shm = ShmStore.open(shm_path)
            except Exception:
                self.shm_path = ""
        self.dead = False

    def _drain_stderr(self, log_callback) -> None:
        pid = self._proc.pid
        try:
            for raw in iter(self._proc.stderr.readline, b""):
                try:
                    log_callback(pid, raw.decode("utf-8", "replace")
                                 .rstrip("\n"))
                except Exception as e:
                    # a log sink must never kill the drain
                    logger.debug("log callback for worker %d failed: "
                                 "%r", pid, e)
        except (ValueError, OSError) as e:
            # pipe closed on shutdown
            logger.debug("stderr drain for worker %d ended: %r", pid, e)

    @property
    def pid(self) -> int:
        return self._proc.pid

    def call(self, msg_type: str, payload: Dict[str, Any]) -> Any:
        """Send one request and block for its reply. Raises
        WorkerCrashedError if the process dies mid-call."""
        with self._lock:
            if self.dead:
                raise WorkerCrashedError(
                    f"worker process {self.pid} already dead")
            try:
                protocol.send(self._proc.stdin, (msg_type, payload),
                              self._shm)
                reply, body = protocol.recv(self._proc.stdout, self._shm)
            except (protocol.PipeClosedError, BrokenPipeError, OSError) as e:
                self._reap_broken()
                raise WorkerCrashedError(
                    f"worker process {self.pid} died during "
                    f"{msg_type} (exit={self._proc.returncode}): {e}"
                ) from None
        if reply == "ok":
            return body
        raise protocol.restore_exception(*body)

    def _reap_broken(self) -> None:
        """The pipe failed, so the process is gone or useless: reap it,
        SIGKILLing one that outlives a short wait, so that its pid is
        gone and its exit code known when the caller hears of the
        crash."""
        self.dead = True
        try:
            self._proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()

    def try_call(self, msg_type: str, payload: Dict[str, Any]) -> Any:
        """``call`` that refuses to wait for the pipe lock: raises
        ``WorkerBusyError`` when an in-flight call holds it. Used by the
        warm-pool return path — a worker still executing a method when
        its actor is killed must be SIGKILLed, not waited on."""
        if not self._lock.acquire(blocking=False):
            raise WorkerBusyError(
                f"worker process {self.pid} has a call in flight")
        try:
            if self.dead:
                raise WorkerCrashedError(
                    f"worker process {self.pid} already dead")
            try:
                protocol.send(self._proc.stdin, (msg_type, payload),
                              self._shm)
                reply, body = protocol.recv(self._proc.stdout, self._shm)
            except (protocol.PipeClosedError, BrokenPipeError, OSError) as e:
                self._reap_broken()
                raise WorkerCrashedError(
                    f"worker process {self.pid} died during "
                    f"{msg_type} (exit={self._proc.returncode}): {e}"
                ) from None
        finally:
            self._lock.release()
        if reply == "ok":
            return body
        raise protocol.restore_exception(*body)

    def ping(self) -> bool:
        try:
            return self.call("ping", {}) == self.pid
        except Exception:
            return False

    def alive(self) -> bool:
        return not self.dead and self._proc.poll() is None

    def terminate(self, timeout: float = 2.0) -> None:
        """``timeout=0`` skips the graceful shutdown message and
        SIGKILLs outright: on a host starved by a large worker fleet,
        waking each worker to read the shutdown frame costs seconds of
        scheduling latency per process — a 2000-actor teardown cannot
        afford it, and a pool-managed worker holds no state worth the
        drain."""
        self.dead = True
        if self._proc.poll() is not None:
            return
        # Never block on the call lock: an in-flight call holds it for
        # the task's whole duration, and terminating a busy worker (kill
        # of a looping actor, pool shutdown) must not hang behind it.
        if timeout > 0 and self._lock.acquire(blocking=False):
            try:
                protocol.send(self._proc.stdin, ("shutdown", {}), None)
            except Exception as e:
                # stdin already closed: the kill below still lands
                logger.debug("graceful shutdown of worker %d failed: "
                             "%r", self.pid, e)
            finally:
                self._lock.release()
            try:
                self._proc.wait(timeout=timeout)
                return
            except subprocess.TimeoutExpired as e:
                logger.debug("worker %d ignored shutdown; killing: %r",
                             self.pid, e)
        self._proc.kill()
        self._proc.wait()


class ProcessWorkerPool:
    """Fixed-size pool of leased worker processes for normal tasks,
    plus (``warm_size > 0``) a warm pool of pre-forked idle workers
    leased instantly to actors."""

    def __init__(self, size: int, shm_path: str = "", log_callback=None,
                 warm_size: int = 0, threads=None):
        self.size = max(1, size)
        self.shm_path = shm_path
        self.log_callback = log_callback
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # raycheck: disable=RC10 — holds at most `size` worker handles (the fixed pool population); nothing else ever enqueues here
        self._idle: deque[WorkerProcess] = deque()
        self._all: List[WorkerProcess] = []
        self._shutdown = False
        self._actor_procs: List["ActorProcess"] = []
        # workers of tasks that demand nothing, started past `size` while
        # every pooled worker is leased (see run): ended after their task
        self._spares: List[WorkerProcess] = []
        for _ in range(self.size):
            self._spawn_locked()
        # ---- warm actor-worker pool (worker_pool.cc prestart) ----
        self.warm_size = max(0, warm_size)
        self._warm_cv = threading.Condition()
        # raycheck: disable=RC10 — bounded by the explicit warm-pool caps: the replenisher stops at warm_size and _warm_return reaps beyond 2*warm_size
        self._warm: deque[WorkerProcess] = deque()
        self.num_warm_hits = 0
        self.num_warm_misses = 0
        self.num_warm_returned = 0
        self.num_warm_reaped = 0
        self.num_warm_specialize_crashes = 0
        if self.warm_size > 0:
            from ray_tpu_torch._private.config import Config

            self._preimport = Config.instance().worker_pool_preimport
            if threads is None:
                from ray_tpu_torch.cluster.threads import ThreadRegistry

                threads = self._own_threads = ThreadRegistry(
                    "process-pool")
            else:
                self._own_threads = None
            threads.spawn(self._replenish_loop, "worker-pool-replenish")
        else:
            self._preimport = ""
            self._own_threads = None

    def _spawn_locked(self) -> None:
        worker = WorkerProcess(self.shm_path,
                               log_callback=self.log_callback)
        self._all.append(worker)
        self._idle.append(worker)

    def _lease(self, wait: bool = True) -> Optional[WorkerProcess]:
        """An idle worker; with ``wait`` False, None when there is none."""
        with self._cv:
            while True:
                if self._shutdown:
                    raise RuntimeError("process pool is shut down")
                while self._idle:
                    worker = self._idle.popleft()
                    if worker.alive():
                        return worker
                    # died while idle: replace it
                    self._all.remove(worker)
                    self._spawn_locked()
                if not wait:
                    return None
                self._cv.wait()

    def _lease_spare(self) -> tuple:
        """An idle pooled worker, else a new one outside the pool ->
        (worker, pooled)."""
        worker = self._lease(wait=False)
        if worker is not None:
            return worker, True
        worker = WorkerProcess(self.shm_path,
                               log_callback=self.log_callback)
        with self._cv:
            if self._shutdown:
                worker.terminate()
                raise RuntimeError("process pool is shut down")
            self._spares.append(worker)
        return worker, False

    def _end_spare(self, worker: WorkerProcess) -> None:
        with self._cv:
            if worker in self._spares:
                self._spares.remove(worker)
        worker.terminate()

    def _release(self, worker: WorkerProcess) -> None:
        with self._cv:
            if worker.dead or not worker.alive():
                if worker in self._all:
                    self._all.remove(worker)
                if not self._shutdown:
                    self._spawn_locked()
            else:
                self._idle.append(worker)
            self._cv.notify()

    # ---------------------------------------------------- warm actor pool
    def _replenish_loop(self) -> None:
        """Keep ``warm_size`` idle workers pre-forked. The fork happens
        OUTSIDE the condition hold — it takes worker-boot time, during
        which leases keep draining the pool without blocking."""
        while True:
            with self._warm_cv:
                while not self._shutdown and \
                        len(self._warm) >= self.warm_size:
                    self._warm_cv.wait(0.5)
                if self._shutdown:
                    return
            try:
                worker = WorkerProcess(self.shm_path,
                                       log_callback=self.log_callback,
                                       preimport=self._preimport)
            except Exception as e:  # noqa: BLE001 — e.g. fork EAGAIN
                logger.warning("warm worker fork failed: %r", e)
                time.sleep(0.5)
                continue
            with self._warm_cv:
                if self._shutdown:
                    stale = worker
                else:
                    self._warm.append(worker)
                    self._warm_cv.notify_all()
                    stale = None
                self._gauge_locked()
            if stale is not None:
                stale.terminate()
                return

    def _gauge_locked(self) -> None:
        from ray_tpu_torch.observability.metrics import worker_pool_size

        worker_pool_size.set(len(self._warm))

    def _warm_lease(self) -> Optional[WorkerProcess]:
        """Pop a live pre-forked worker, or None (cold-fork fallback).
        Counts the hit/miss either way."""
        from ray_tpu_torch.observability.metrics import (
            worker_pool_warm_hits,
            worker_pool_warm_misses,
        )

        reap = []
        try:
            with self._warm_cv:
                while self._warm:
                    worker = self._warm.popleft()
                    self._warm_cv.notify_all()  # wake the replenisher
                    if worker.alive():
                        self.num_warm_hits += 1
                        worker_pool_warm_hits.inc()
                        return worker
                    reap.append(worker)  # died while idle
                self.num_warm_misses += 1
                worker_pool_warm_misses.inc()
                return None
        finally:
            with self._warm_cv:
                self._gauge_locked()
            for w in reap:
                w.terminate()

    def _warm_return(self, proc: "ActorProcess") -> bool:
        """Return a killed actor's worker to the warm pool if it is
        demonstrably clean; else reap it. True = worker kept alive in
        the pool (the caller must NOT terminate it)."""
        worker = proc.worker
        clean = (not self._shutdown and not proc.had_runtime_env
                 and worker.alive())
        if clean:
            with self._warm_cv:
                # capacity pre-check BEFORE paying the actor_reset
                # round trip: during a fleet teardown most workers are
                # headed for the reaper anyway, and waking each one to
                # reset it first costs seconds apiece on a starved host
                clean = len(self._warm) < 2 * self.warm_size
        if clean:
            try:
                # non-blocking: a worker mid-method (busy kill) must be
                # SIGKILLed, matching the dedicated-process semantics
                reply = worker.try_call("actor_reset", {})
                clean = bool(reply and reply.get("clean"))
            except Exception as e:  # noqa: BLE001 — busy/crashed/errored
                logger.debug("actor_reset of worker %d failed: %r",
                             worker.pid, e)
                clean = False
        if clean:
            with self._warm_cv:
                # accept returns past warm_size (they pre-empt the next
                # replenisher fork) but never hoard beyond 2x
                if not self._shutdown and \
                        len(self._warm) < 2 * self.warm_size:
                    self._warm.append(worker)
                    self.num_warm_returned += 1
                    self._warm_cv.notify_all()
                    self._gauge_locked()
                    return True
        with self._warm_cv:
            self.num_warm_reaped += 1
        return False

    def run(self, func, args: tuple, kwargs: dict,
            runtime_env=None, result_key: Optional[bytes] = None,
            spare: bool = False) -> Any:
        """``result_key`` (a 20-byte shm-store key) asks the worker to
        write a large result straight into the node's shm segment under
        that key and reply with a protocol.StoredResult marker — the
        caller then adopts the segment entry without the payload ever
        crossing the pipe. ``spare``: the task demands no resource, so
        it holds no slot of the pool; when every pooled worker is
        leased it runs on a worker started for it and ended after it
        (reference: the worker pool starts workers past its soft limit),
        instead of waiting behind the tasks that hold the node's CPUs
        (a job's entrypoint, which a stop signal must reach)."""
        worker, pooled = self._lease_spare() if spare else (
            self._lease(), True)
        try:
            return worker.call("task", {
                "func": func, "args": args, "kwargs": kwargs,
                "runtime_env": runtime_env,
                "result_key": result_key,
            })
        finally:
            if pooled:
                self._release(worker)
            else:
                self._end_spare(worker)

    def run_batch(self, items: List[dict]) -> List[tuple]:
        """Batched ``run`` (dispatch fast lane): lease ONE worker and
        ship all ``items`` — each the same payload dict ``run`` sends
        (func/args/kwargs/runtime_env/result_key) — as a single
        ``task_batch`` pipe frame; the worker executes them serially
        and the N results come back in one reply frame. Returns one
        ``("ok", value)`` or ``("err", exception)`` row per item, in
        order: a row's user exception never fails its siblings. Only a
        worker death mid-batch raises (WorkerCrashedError), failing
        the whole batch for the caller to fan out."""
        worker = self._lease()
        try:
            rows = worker.call("task_batch", {"items": items})
        finally:
            self._release(worker)
        return [(status, body) if status == "ok"
                else (status, protocol.restore_exception(*body))
                for status, body in rows]

    def create_actor_process(self, cls, args: tuple, kwargs: dict,
                             runtime_env=None) -> "ProcessActorProxy":
        proc = None
        if self.warm_size > 0:
            worker = self._warm_lease()
            if worker is not None:
                try:
                    proc = ActorProcess(cls, args, kwargs, runtime_env,
                                        worker=worker, pool=self)
                except WorkerCrashedError:
                    # the leased worker died between the liveness check
                    # and specialization (its dead pipe is already
                    # reaped by ActorProcess): cold-fork below without
                    # surfacing an error — the caller never sees the
                    # burned lease. User __init__ errors re-raise — a
                    # fresh fork cannot fix those.
                    from ray_tpu_torch.observability.metrics import (
                        warm_specialize_crash_fallbacks,
                    )

                    with self._warm_cv:
                        self.num_warm_specialize_crashes += 1
                        self.num_warm_reaped += 1
                    warm_specialize_crash_fallbacks.inc()
                    logger.info(
                        "warm worker %d died during in-place "
                        "specialization; reaped, cold-forking instead",
                        worker.pid)
                    proc = None
        if proc is None:
            proc = ActorProcess(cls, args, kwargs, runtime_env,
                                shm_path=self.shm_path,
                                log_callback=self.log_callback,
                                pool=self if self.warm_size > 0 else None)
        with self._lock:
            # prune incarnations whose processes are gone (killed or
            # crash-looped actors; a pool-returned worker outlives its
            # actor, so `gone` is checked too) so the registry doesn't
            # grow unboundedly
            self._actor_procs = [p for p in self._actor_procs
                                 if p.worker.alive() and not p.gone]
            self._actor_procs.append(proc)
        return ProcessActorProxy(proc)

    def pids(self) -> List[int]:
        with self._lock:
            return [w.pid for w in self._all if w.alive()]

    def stats(self) -> dict:
        with self._lock:
            out = {
                "size": self.size,
                "alive": sum(1 for w in self._all if w.alive()),
                "idle": len(self._idle),
                "actors": sum(1 for p in self._actor_procs
                              if p.worker.alive() and not p.gone),
            }
        with self._warm_cv:
            out.update({
                "warm_size": self.warm_size,
                "warm_idle": len(self._warm),
                "warm_hits": self.num_warm_hits,
                "warm_misses": self.num_warm_misses,
                "warm_returned": self.num_warm_returned,
                "warm_reaped": self.num_warm_reaped,
                "warm_specialize_crashes":
                    self.num_warm_specialize_crashes,
            })
        return out

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            workers = list(self._all) + self._spares
            actors = list(self._actor_procs)
            self._spares = []
            self._all.clear()
            self._idle.clear()
            self._cv.notify_all()
        with self._warm_cv:
            warm = list(self._warm)
            self._warm.clear()
            self._warm_cv.notify_all()
        for w in warm:
            w.terminate()
        for w in workers:
            w.terminate()
        for a in actors:
            a.terminate()
        if self._own_threads is not None:
            self._own_threads.join_all(timeout=2.0)


class ActorProcess:
    """A worker process holding one live actor instance — either a
    freshly forked dedicated child (classic path) or a warm worker
    leased from the pool and specialized in place (``worker=``)."""

    def __init__(self, cls, args: tuple, kwargs: dict, runtime_env=None,
                 shm_path: str = "", log_callback=None,
                 worker: Optional[WorkerProcess] = None, pool=None):
        self.pool = pool
        self.had_runtime_env = runtime_env is not None
        self.warm = worker is not None
        self.gone = False  # terminated (worker may live on in the pool)
        self.worker = worker if worker is not None else WorkerProcess(
            shm_path, log_callback=log_callback)
        try:
            self.worker.call("actor_create", {
                "cls": cls, "args": args, "kwargs": kwargs,
                "runtime_env": runtime_env,
            })
        except BaseException:
            # covers user __init__ errors too: the worker may hold a
            # half-entered runtime_env, so it never returns to the pool
            self.worker.terminate()
            raise

    @property
    def pid(self) -> int:
        return self.worker.pid

    def call_method(self, method: str, args: tuple, kwargs: dict) -> Any:
        return self.worker.call("actor_call", {
            "method": method, "args": args, "kwargs": kwargs,
        })

    def terminate(self) -> None:
        self.gone = True
        if self.pool is not None:
            if self.pool._warm_return(self):
                return  # worker reset clean and rejoined the warm pool
            # pool-managed reap: hard-kill. The graceful 2 s wait per
            # worker — not the RPC chain — is what made a 2000-actor
            # teardown take 204 s on a starved host, and a
            # declined return means the worker's state is disposable.
            self.worker.terminate(timeout=0.0)
            return
        self.worker.terminate()  # dedicated-process (pool-off) path


class ProcessActorProxy:
    """Stands in for the actor instance inside the parent's ActorExecutor:
    attribute access returns a callable that pushes the method call to the
    dedicated process. Mirrors how the reference's ActorHandle proxies
    method descriptors to the remote worker."""

    def __init__(self, proc: ActorProcess):
        # deliberately obscure attribute name: anything the proxy defines
        # shadows a same-named user actor method (getattr resolution)
        object.__setattr__(self, "_ray_tpu_actor_proc", proc)

    def __getattr__(self, name: str):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        proc = object.__getattribute__(self, "_ray_tpu_actor_proc")

        def _call(*args, **kwargs):
            return proc.call_method(name, args, kwargs)

        _call.__name__ = name
        return _call

    def __ray_proxy_pid__(self) -> int:
        return object.__getattribute__(self, "_ray_tpu_actor_proc").pid

    def __ray_on_kill__(self) -> None:
        object.__getattribute__(self, "_ray_tpu_actor_proc").terminate()
