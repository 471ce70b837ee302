"""Wire protocol between the parent runtime and worker processes.

Frames: 8-byte big-endian length + body over the worker's stdin/stdout
pipes (the raylet<->worker control channel; the reference uses a unix
socket + gRPC, src/ray/core_worker/core_worker_process.cc).

Bodies are cloudpickle protocol-5 payloads. Out-of-band PickleBuffers
larger than ``SHM_THRESHOLD`` travel through the shared-memory store
(plasma equivalent) instead of the pipe: the body carries
``(pickled, inline_buffers, shm_ids)`` and the receiver stitches the
buffer list back together in order. Small messages stay fully inline so
the protocol works without the native store.
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
from typing import List, Optional, Tuple

import cloudpickle

logger = logging.getLogger(__name__)

SHM_THRESHOLD = 64 * 1024  # bytes; below this, inline in the frame
_LEN = struct.Struct(">Q")

# Pipe-protocol version: the parent passes it on the worker command
# line and the worker refuses a mismatch at startup (parent and child
# normally come from one checkout, but a worker resolved against a
# stale install must fail loudly, not mis-parse frames). Bump on any
# incompatible change to the frame or marker-class layout.
# History: 1 = framed cloudpickle-5 + shm out-of-band buffers +
#              StoredObjectArg/StoredResult/FlatPayload markers.
PIPE_PROTOCOL_VERSION = 1

# marker distinguishing inline from shm-carried buffers, in order
_INLINE = 0
_SHM = 1


class PipeClosedError(ConnectionError):
    """The peer process closed its end (it exited or was killed)."""


class StoredObjectArg:
    """Marker for a task argument whose payload sits in a shm store
    segment ON THIS HOST: the raylet sends this 20-byte key down the
    pipe instead of the (possibly huge) value, and the worker reads the
    segment directly — the plasma worker-mmap contract (reference:
    workers map plasma and deserialize in place; only metadata crosses
    the socket). ``path`` is None for the node's own segment, or a
    same-host PEER raylet's segment — consuming a neighbour's object
    costs a pin and a page-table walk, not a copy (plasma's one-store-
    per-host model). The raylet holds a pin until the task ends."""

    __slots__ = ("key", "path", "offset", "size")

    def __init__(self, key: bytes, path: Optional[str] = None,
                 offset: Optional[int] = None,
                 size: Optional[int] = None):
        self.key = key
        self.path = path
        # peer-segment args carry the pinned block's (offset, size): the
        # worker reads the region under the raylet's pin without a
        # state lookup, so a concurrent spill/delete on the OWNER (which
        # defers while pinned) cannot fail the read
        self.offset = offset
        self.size = size


class StoredResult:
    """Marker reply for a task result the worker wrote directly into
    the node's shm store segment under the return key (plasma: workers
    create+seal in the store; the raylet merely pins). Carries the
    payload size for the raylet's capacity accounting."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = nbytes


class FlatPayload:
    """Reply wrapper for a small task result already serialized in the
    flat stored-object format: the raylet stores ``body`` verbatim
    instead of deserializing the value and re-serializing it — one
    serialization per result, total."""

    __slots__ = ("body",)

    def __init__(self, body: bytes):
        self.body = body


def write_frame(fp, body: bytes) -> None:
    fp.write(_LEN.pack(len(body)))
    fp.write(body)
    fp.flush()


def _read_exact(fp, n: int) -> bytes:
    """Pipes deliver short reads (raw unbuffered FileIO, 64KB pipe
    buffer): loop until the full n bytes arrive or the peer closes."""
    chunks = []
    remaining = n
    while remaining:
        chunk = fp.read(remaining)
        if not chunk:
            raise PipeClosedError(
                f"pipe closed with {remaining}/{n} bytes outstanding")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def read_frame(fp) -> bytes:
    (length,) = _LEN.unpack(_read_exact(fp, _LEN.size))
    return _read_exact(fp, length)


def dumps(obj, shm_store=None) -> bytes:
    """Serialize with protocol-5; large buffers spill to the shm store."""
    plan: List[Tuple[int, object]] = []  # (_INLINE, bytes) | (_SHM, oid)

    def _buffer_cb(pb: pickle.PickleBuffer):
        raw = pb.raw()
        if shm_store is not None and raw.nbytes >= SHM_THRESHOLD:
            oid = os.urandom(20)
            try:
                shm_store.put_bytes(oid, raw)
                plan.append((_SHM, oid))
                return False  # consumed out-of-band
            except Exception as e:
                # store full/closed: fall through to inline
                logger.debug("shm spill of %d-byte buffer failed; "
                             "inlining: %r", raw.nbytes, e)
        plan.append((_INLINE, raw.tobytes()))
        return False

    pickled = cloudpickle.dumps(obj, protocol=5, buffer_callback=_buffer_cb)
    return pickle.dumps((pickled, plan), protocol=4)


def loads(body: bytes, shm_store=None):
    pickled, plan = pickle.loads(body)
    buffers = []
    shm_ids = []
    for kind, payload in plan:
        if kind == _INLINE:
            buffers.append(payload)
        else:
            if shm_store is None:
                raise RuntimeError(
                    "message carries shm buffers but no store is attached")
            data = shm_store.get_bytes(payload)
            if data is None:
                raise RuntimeError("shm buffer missing (evicted?)")
            buffers.append(data)
            shm_ids.append(payload)
    obj = pickle.loads(pickled, buffers=buffers)
    # The copies made by get_bytes are owned by `obj` now; drop the shm
    # entries so one-shot transfer buffers don't accumulate.
    for oid in shm_ids:
        try:
            shm_store.delete(oid)
        except Exception as e:
            # leaked one-shot buffer; segment close reclaims it
            logger.debug("transfer-buffer %s cleanup failed: %r",
                         oid.hex()[:8], e)
    return obj


# --------------------------------------------------------------------------
# Flat STORED-OBJECT format (the object-store payload layout).
#
# Layout: 8-byte header length | header | buffer0 | buffer1 | ...
# where header = pickle((pickled_obj, [buffer sizes])). The point of the
# flatness: `loads_flat` reconstructs pickle-5 out-of-band buffers as
# SLICES OF THE INPUT VIEW — deserializing straight out of a pinned shm
# segment costs zero copies and faults only the pages actually touched
# (the plasma zero-copy read contract: workers mmap the store and numpy
# arrays view it in place). Views are handed out READ-ONLY, matching the
# reference's immutable-object semantics for plasma-backed arrays.
# --------------------------------------------------------------------------

def flat_parts(obj) -> Tuple[bytes, List]:
    """(header, raw_buffers) for writing an object in the flat format."""
    bufs: List = []

    def _cb(pb: pickle.PickleBuffer):
        raw = pb.raw()
        bufs.append(raw if raw.ndim == 1 else raw.cast("B"))
        return False

    pickled = cloudpickle.dumps(obj, protocol=5, buffer_callback=_cb)
    header = pickle.dumps((pickled, [b.nbytes for b in bufs]), protocol=5)
    return header, bufs


def flat_size(header: bytes, bufs: List) -> int:
    return _LEN.size + len(header) + sum(b.nbytes for b in bufs)


def write_flat(dest, header: bytes, bufs: List) -> None:
    """Assemble the flat layout into ``dest`` (a writable buffer of
    exactly flat_size bytes) — used to serialize DIRECTLY into a shm
    segment allocation with no intermediate joined copy."""
    mv = memoryview(dest)
    mv[:_LEN.size] = _LEN.pack(len(header))
    off = _LEN.size
    mv[off:off + len(header)] = header
    off += len(header)
    for b in bufs:
        n = b.nbytes
        mv[off:off + n] = b
        off += n


def dumps_flat(obj) -> bytearray:
    header, bufs = flat_parts(obj)
    out = bytearray(flat_size(header, bufs))
    write_flat(out, header, bufs)
    return out


def loads_flat(body):
    """Deserialize a flat payload. ``body`` may be bytes or a memoryview
    over a pinned shm segment — big buffers become read-only views of
    it, so the caller must keep the underlying pin/owner alive for the
    lifetime of the returned object's arrays."""
    view = memoryview(body).toreadonly()
    if len(view) and view[0] == 0x80:
        # legacy inline-pickle payload (0x80 = pickle PROTO opcode; a
        # flat header-length big-endian u64 always starts 0x00)
        return loads(bytes(view))
    (hlen,) = _LEN.unpack(view[:_LEN.size])
    pickled, sizes = pickle.loads(view[_LEN.size:_LEN.size + hlen])
    off = _LEN.size + hlen
    buffers = []
    for n in sizes:
        buffers.append(view[off:off + n])
        off += n
    return pickle.loads(pickled, buffers=buffers)


def send(fp, obj, shm_store=None) -> None:
    write_frame(fp, dumps(obj, shm_store))


def recv(fp, shm_store=None):
    return loads(read_frame(fp), shm_store)


def format_exception(exc: BaseException) -> tuple:
    """(pickled exception | None, traceback text, repr) — the exception
    object itself may not be picklable; the parent falls back to repr."""
    import traceback

    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        payload: Optional[bytes] = cloudpickle.dumps(exc)
        pickle.loads(payload)  # must round-trip parent-side too
    except Exception:
        payload = None
    return payload, tb, repr(exc)


def restore_exception(payload, tb: str, rep: str) -> BaseException:
    if payload is not None:
        try:
            exc = pickle.loads(payload)
            exc._worker_traceback = tb
            return exc
        except Exception as e:
            # fall through to the repr-based RuntimeError below
            logger.debug("stored exception payload failed to "
                         "unpickle: %r", e)
    return RuntimeError(f"task failed in worker process: {rep}\n{tb}")
