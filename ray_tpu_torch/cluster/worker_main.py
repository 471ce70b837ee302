"""Worker-process entry point (``python -m ray_tpu_torch.cluster.worker_main``).

The process equivalent of the reference's
python/ray/workers/default_worker.py: connect back to the parent, then
loop executing pushed work until told to shut down
(CoreWorker::RunTaskExecutionLoop, core_worker.cc:2018).

Protocol (see cluster/protocol.py) rides the original stdin/stdout pipe
pair; user ``print``s are re-routed to stderr so they cannot corrupt
frames. Messages:

  ("task",        {func, args, kwargs, runtime_env}) -> ("ok", result) | ("err", ...)
  ("task_batch",  {items: [task payloads]})          -> ("ok", [row, ...])
  ("actor_create",{cls, args, kwargs, runtime_env})  -> ("ok", None)   | ("err", ...)
  ("actor_call",  {method, args, kwargs})            -> ("ok", result) | ("err", ...)
  ("actor_reset", {})                                -> ("ok", {clean}) | ("err", ...)
  ("ping",        {})                                -> ("ok", pid)
  ("shutdown",    {})                                -> process exits 0

``actor_reset`` tears the live actor instance down so a WARM-POOL
worker can return to its pool after a kill (process_pool.py). The
reply's ``clean`` is False when the actor's life polluted process
state the reset cannot undo (a runtime_env held for the actor's whole
life) — the parent reaps such workers instead of reusing them.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import logging
import os
import sys

from ray_tpu_torch.cluster import protocol

logger = logging.getLogger(__name__)


def _resolve_stored_args(args, kwargs, shm, held_keys):
    """Swap StoredObjectArg markers for values deserialized IN PLACE
    from the node's shm segment: numpy buffers become read-only views of
    the mapped pages — zero copies, and only the pages the task actually
    touches ever fault in (the plasma worker-mmap read contract). Each
    resolved key is pinned (C-store refcount) and appended to
    ``held_keys``; the caller releases them after the reply is sent.
    The raylet additionally holds its own pin for the task's duration.
    Retaining a view beyond the task (e.g. stashing the array in a
    global) is undefined once both pins drop — the reference makes the
    same immutable/zero-copy trade for plasma-backed arrays."""
    def resolve(a):
        if not isinstance(a, protocol.StoredObjectArg):
            return a
        if a.path is not None:
            # same-host PEER segment (plasma one-store-per-host: the
            # neighbour raylet's object is readable in place). The
            # RAYLET holds the pin and shipped the block's
            # (offset, size): read the region directly — no state
            # lookup, so a concurrent spill/delete on the owner (which
            # defers while pinned) cannot fail this read.
            from ray_tpu_torch.cluster.byte_store import attach_shm

            seg = attach_shm(a.path)
            if seg is None:
                raise RuntimeError(
                    f"peer shm segment {a.path} unreachable")
            return protocol.loads_flat(seg.region(a.offset, a.size))
        if shm is None:
            raise RuntimeError(
                "task argument lives in the shm store but this worker "
                "has no segment attached")
        # the pin is keyed into held_keys two lines down and released
        # by the task-end unwind in _serve_one; buf is a borrowed view
        # raycheck: disable=RC12 — pin recorded in held_keys, released at task end
        buf = shm.get_buffer(a.key)
        if buf is None:
            raise RuntimeError(
                "stored task argument missing from the shm segment")
        held_keys.append((shm, a.key))
        return protocol.loads_flat(buf)

    return ([resolve(a) for a in args],
            {k: resolve(v) for k, v in kwargs.items()})


def _store_result(result, result_key, shm):
    """Large results are serialized DIRECTLY into the node's shm segment
    under the return key (create -> write flat layout -> seal; no
    intermediate joined buffer) and only a size marker rides the pipe —
    the plasma write path, where workers create+seal in the store and
    the raylet merely pins. Falls back to the inline reply when the
    segment is full or the key already exists (e.g. a retry)."""
    if result_key is None:
        return ("ok", result)
    header, bufs = protocol.flat_parts(result)
    total = protocol.flat_size(header, bufs)
    if total < protocol.SHM_THRESHOLD or shm is None:
        # small result: ship the flat payload itself — the raylet
        # stores it verbatim, so the value is serialized exactly once
        out = bytearray(total)
        protocol.write_flat(out, header, bufs)
        return ("ok", protocol.FlatPayload(bytes(out)))
    from ray_tpu_torch.cluster import integrity

    trailer_size = integrity.TRAILER_SIZE if integrity.enabled() else 0
    try:
        # integrity plane: the segment entry is created logical-size +
        # trailer; the digest of the flat payload rides after it, so
        # the raylet verifies the bytes at adopt_shm — a worker
        # SIGKILLed mid-write (or a scribbled page) can never become
        # the node's primary copy
        dest = shm.create(result_key, total + trailer_size)
        try:
            body = dest[:total] if trailer_size else dest
            try:
                protocol.write_flat(body, header, bufs)
                if trailer_size:
                    dest[total:] = integrity.pack_trailer(
                        integrity.checksum(body))
            finally:
                if body is not dest:
                    body.release()
        finally:
            dest.release()
        shm.seal(result_key)
    except Exception:
        out = bytearray(total)
        protocol.write_flat(out, header, bufs)
        return ("ok", protocol.FlatPayload(bytes(out)))
    return ("ok", protocol.StoredResult(total))


def _execute(func, args, kwargs, runtime_env):
    if runtime_env is not None:
        with runtime_env.applied():
            result = func(*args, **kwargs)
    else:
        result = func(*args, **kwargs)
    if inspect.isawaitable(result):
        # async actor methods are awaited worker-side; the parent's
        # ordering queue only sees the final value
        result = asyncio.run(_consume(result))
    return result


async def _consume(awaitable):
    return await awaitable


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shm", default="", help="shm store path (optional)")
    parser.add_argument("--protocol-version", type=int, default=None,
                        help="parent's pipe-protocol version; refuse on "
                             "mismatch instead of mis-parsing frames")
    parser.add_argument("--preimport", default="",
                        help="comma-separated modules to import at boot "
                             "(warm-pool amortization: the import cost is "
                             "paid before the worker is ever leased)")
    ns = parser.parse_args()
    if (ns.protocol_version is not None
            and ns.protocol_version != protocol.PIPE_PROTOCOL_VERSION):
        print(f"worker: pipe protocol v{ns.protocol_version} != "
              f"v{protocol.PIPE_PROTOCOL_VERSION}; refusing to start",
              file=sys.stderr)
        return 2

    # Claim the protocol fds, then point fd1 (and Python's sys.stdout) at
    # stderr so user code can't write into the frame stream.
    # raycheck: disable=RC12 — process-lifetime protocol fd; exit reclaims
    proto_in = os.fdopen(os.dup(0), "rb", buffering=0)
    # raycheck: disable=RC12 — process-lifetime protocol fd; exit reclaims
    proto_out = os.fdopen(os.dup(1), "wb", buffering=0)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    sys.stdin = open(os.devnull, "r")

    shm = None
    if ns.shm:
        try:
            from ray_tpu_torch._native.shm_store import ShmStore

            # raycheck: disable=RC12 — process-lifetime segment mapping; exit reclaims
            shm = ShmStore.open(ns.shm)
        except Exception as e:  # noqa: BLE001
            print(f"worker: shm store unavailable ({e}); inline transport",
                  file=sys.stderr)

    os.environ["RAY_TPU_WORKER_PROCESS"] = "1"
    if ns.preimport:
        import importlib

        for mod in ns.preimport.split(","):
            mod = mod.strip()
            if not mod:
                continue
            try:
                importlib.import_module(mod)
            except Exception as e:  # noqa: BLE001 — best-effort warmup
                print(f"worker: preimport of {mod} failed: {e!r}",
                      file=sys.stderr)
    actor_instance = None
    actor_env = None

    while True:
        held_keys: list = []  # segment pins released after the reply
        try:
            msg_type, payload = protocol.recv(proto_in, shm)
        except protocol.PipeClosedError:
            return 0
        if msg_type == "shutdown":
            return 0
        try:
            if msg_type == "ping":
                reply = ("ok", os.getpid())
            elif msg_type == "task":
                args, kwargs = _resolve_stored_args(
                    payload["args"], payload["kwargs"], shm, held_keys)
                result = _execute(payload["func"], args, kwargs,
                                  payload.get("runtime_env"))
                reply = _store_result(result, payload.get("result_key"),
                                      shm)
            elif msg_type == "task_batch":
                # dispatch fast lane: N task frames per pipe write —
                # one recv, N executions, one reply frame. Rows are
                # independent: a row's exception becomes that row's
                # ("err", ...) entry instead of failing the frame, so
                # siblings in the batch still return their results.
                rows = []
                for item in payload["items"]:
                    try:
                        args, kwargs = _resolve_stored_args(
                            item["args"], item["kwargs"], shm,
                            held_keys)
                        result = _execute(item["func"], args, kwargs,
                                          item.get("runtime_env"))
                        rows.append(_store_result(
                            result, item.get("result_key"), shm))
                    except BaseException as e:  # noqa: BLE001
                        if isinstance(e, SystemExit):
                            raise
                        rows.append(
                            ("err", protocol.format_exception(e)))
                reply = ("ok", rows)
            elif msg_type == "actor_create":
                actor_env = payload.get("runtime_env")
                if actor_env is not None:
                    # the env holds for the actor's whole life (reference:
                    # runtime envs are per worker process)
                    actor_env.__enter__ctx = actor_env.applied()
                    actor_env.__enter__ctx.__enter__()
                actor_instance = payload["cls"](*payload["args"],
                                                **payload["kwargs"])
                reply = ("ok", None)
            elif msg_type == "actor_call":
                if actor_instance is None:
                    raise RuntimeError("actor_call before actor_create")
                method = getattr(actor_instance, payload["method"])
                result = _execute(method, payload["args"], payload["kwargs"],
                                  None)
                reply = ("ok", result)
            elif msg_type == "actor_reset":
                # a runtime_env held for the actor's life may have
                # mutated process state (env vars, cwd) in ways user
                # code already observed; exiting the ctx restores the
                # env but the worker is conservatively unfit for reuse
                clean = actor_env is None
                if actor_env is not None:
                    try:
                        actor_env.__enter__ctx.__exit__(None, None, None)
                    except Exception as e:  # noqa: BLE001
                        print(f"worker: runtime_env teardown failed: "
                              f"{e!r}", file=sys.stderr)
                    actor_env = None
                actor_instance = None
                import gc

                gc.collect()  # run the instance's __del__ before reuse
                reply = ("ok", {"clean": clean})
            else:
                raise RuntimeError(f"unknown message type {msg_type!r}")
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, SystemExit):
                raise
            reply = ("err", protocol.format_exception(e))
        try:
            protocol.send(proto_out, reply, shm)
        except protocol.PipeClosedError:
            return 0
        except Exception as e:  # noqa: BLE001 — unpicklable result
            protocol.send(
                proto_out,
                ("err", protocol.format_exception(
                    TypeError(f"task result is not serializable: {e}"))),
                shm)
        finally:
            # the reply (which may reference arg views) is fully
            # serialized and flushed: safe to drop the segment pins
            del reply
            for seg, key in held_keys:
                try:
                    seg.release(key)
                except Exception as e:
                    # the owning raylet may have torn the segment down
                    logger.debug("worker: releasing shm arg pin %s "
                                 "failed: %r", key.hex()[:8], e)


if __name__ == "__main__":
    sys.exit(main())
