"""Binary identifiers for every entity in the system.

Mirrors the reference's ID scheme (src/ray/common/id.h and
src/ray/design_docs/id_specification.md) so that sizes, nesting and
deterministic derivation match:

  JobID                4 bytes
  ActorID             16 bytes  = 12 unique + 4 JobID
  TaskID              24 bytes  =  8 unique + 16 ActorID
  ObjectID            28 bytes  = 24 TaskID + 4 return/put index
  PlacementGroupID    18 bytes  = 14 unique + 4 JobID
  UniqueID (Node/Worker/Cluster)  28 bytes

IDs are immutable, hashable, and order-comparable on their raw bytes.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import ClassVar, Optional

_NIL_CACHE: dict = {}

_RAND_CHUNK = 8192
_rand_tls = threading.local()


def _reset_rand_buffer() -> None:
    # A forked child would replay the parent's buffered bytes and mint
    # identical IDs; drop the cache so the child refills from urandom.
    _rand_tls.buf = b""
    _rand_tls.pos = 0


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_rand_buffer)


def fast_random_bytes(n: int) -> bytes:
    """os.urandom amortized over a thread-local buffer.

    ID minting is on the task-submit hot path (one TaskID + num_returns
    ObjectIDs per call); a urandom syscall per ID dominated the submit
    profile. Entropy is unchanged — bytes still come from os.urandom,
    just in 8 KiB refills.
    """
    if n > _RAND_CHUNK:
        return os.urandom(n)
    buf = getattr(_rand_tls, "buf", b"")
    pos = getattr(_rand_tls, "pos", 0)
    if pos + n > len(buf):
        buf = os.urandom(_RAND_CHUNK)
        pos = 0
        _rand_tls.buf = buf
    _rand_tls.pos = pos + n
    return buf[pos:pos + n]


class BaseID:
    SIZE: ClassVar[int] = 28

    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes):
            raise TypeError(f"expected bytes, got {type(binary)}")
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._binary = binary
        self._hash = hash((type(self).__name__, binary))

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_random(cls):
        return cls(fast_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        key = cls.__name__
        if key not in _NIL_CACHE:
            _NIL_CACHE[key] = cls(b"\xff" * cls.SIZE)
        return _NIL_CACHE[key]

    # -- accessors ---------------------------------------------------------
    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    # -- dunder ------------------------------------------------------------
    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (
            type(other) is type(self) and other._binary == self._binary
        )

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class UniqueID(BaseID):
    SIZE = 28


class NodeID(UniqueID):
    pass


class WorkerID(UniqueID):
    pass


class ClusterID(UniqueID):
    pass


class FunctionID(UniqueID):
    pass


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack(">I", value))

    def int_value(self) -> int:
        return struct.unpack(">I", self._binary)[0]


class ActorID(BaseID):
    SIZE = 16
    UNIQUE_BYTES = 12

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(fast_random_bytes(cls.UNIQUE_BYTES) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[self.UNIQUE_BYTES :])


class TaskID(BaseID):
    SIZE = 24
    UNIQUE_BYTES = 8

    @classmethod
    def for_task(cls, actor_id: Optional[ActorID] = None) -> "TaskID":
        aid = actor_id if actor_id is not None else ActorID.nil()
        return cls(fast_random_bytes(cls.UNIQUE_BYTES) + aid.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        # The driver's root task: zero unique bytes + a nil-actor whose
        # job slot carries the job id, so lineage roots are recognizable.
        aid = ActorID(b"\x00" * ActorID.UNIQUE_BYTES + job_id.binary())
        return cls(b"\x00" * cls.UNIQUE_BYTES + aid.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._binary[self.UNIQUE_BYTES :])


class ObjectID(BaseID):
    SIZE = 28
    INDEX_BYTES = 4

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        # index starts at 1, like the reference (return 0 is reserved).
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Puts use the high bit of the index word to avoid colliding with
        # return objects of the same task.
        return cls(task_id.binary() + struct.pack(">I", 0x80000000 | put_index))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[: TaskID.SIZE])

    def return_index(self) -> int:
        return struct.unpack(">I", self._binary[TaskID.SIZE :])[0] & 0x7FFFFFFF

    def is_put(self) -> bool:
        return bool(struct.unpack(">I", self._binary[TaskID.SIZE :])[0] & 0x80000000)


class PlacementGroupID(BaseID):
    SIZE = 18
    UNIQUE_BYTES = 14

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(fast_random_bytes(cls.UNIQUE_BYTES) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[self.UNIQUE_BYTES :])
