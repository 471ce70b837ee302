"""Integrity plane — end-to-end object checksums at every
data-movement seam.

The fault plane (cluster/fault_plane.py) covers *loss* — dropped,
delayed, duplicated, truncated frames — and the overload plane covers
*load*. Neither covers a payload that arrives **wrong**: a flipped bit
in a push chunk, a spill file half-written by a SIGKILLed raylet, or a
shm segment scribbled by a dying worker flows through every transfer
seam unverified and becomes a silently-wrong ``ray.get()`` result.
Production fleets see exactly this class of silent data corruption at
scale (Hochschild et al., "Cores that don't count", HotOS '21; Dixit
et al., "Silent Data Corruptions at Scale", '21). The reference's
plasma store seals objects immutably and its transfer plane moves
sealed chunks; this module adds the missing end-to-end check.

Design: ONE digest per object, computed at creation (``ByteStore.put``
/ the worker's shm result write / spill time in ``MemoryStore``) and
carried alongside the payload across every boundary:

- entry metadata (``_Entry.crc`` / ``StoredObject.crc``),
- the push wire schema (optional ``crc`` on ``push_begin`` /
  ``push_chunk`` / ``push_offer``, cluster/schema.py),
- the chunked pull stream's header frame (``get_object``),
- a spill-file header (``SPILL_MAGIC`` + flags + crc, written by both
  store tiers),
- a shm segment trailer (``TRAILER_MAGIC`` + crc appended after the
  payload inside the segment entry, invisible to readers that slice
  the logical size).

Verification fires where bytes cross a trust boundary: push-receive
assembly, pull completion, spill restore, ``adopt_shm`` and orphan
spill-file reclaim, and (knob-gated, default off) at ``ray.get``
deserialization. On mismatch the holder raises the typed
:class:`~ray_tpu_torch.exceptions.ObjectCorruptedError`, discards the
corrupt replica, and the normal recovery machinery — re-pull from
another holder, push retry, lineage reconstruction — delivers the
correct value or a typed error. Never garbage.

The digest is CRC32C (Castagnoli) via the hardware-accelerated
``google_crc32c`` C extension when present (~20 GiB/s with SSE4.2 /
ARMv8 CRC instructions), falling back to zlib.crc32 (~1 GiB/s
slice-by-8; hashlib.blake2b-8 measured 0.68 GiB/s, adler32 is faster
but weak on short payloads). Either is strong enough for fault
detection (this is an integrity check against bit rot and torn
writes, not an authenticity check against an adversary). The backend
is chosen once at import and is identical across every process of an
incarnation (driver, raylets, pipe workers share the interpreter and
site-packages), so digests agree at every seam; only orphan spill
files written by an incarnation with a DIFFERENT backend fail their
header check at reclaim — and are dropped, which is the designed
response to any unverifiable spill. ``bench.py`` records the cost as
``integrity_overhead_pct`` on the broadcast and scheduler rows and
``integrity_store_put_get_overhead_pct`` at the store layer.

Knobs (``_private/config.py``): ``integrity_enabled`` (master switch,
default on) and ``integrity_verify_on_get`` (the paranoid end-to-end
re-check at deserialization, default off — every transfer seam already
verified the bytes it moved).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

# ---------------------------------------------------------------- digest

try:
    # hardware CRC32C: the C extension only — the package's pure-python
    # fallback is slower than zlib and would invert the trade
    from google_crc32c import extend as _crc32c_extend
    from google_crc32c import implementation as _crc32c_impl
    from google_crc32c import value as _crc32c_value

    if _crc32c_impl != "c":
        _crc32c_value = None
        _crc32c_extend = None
except ImportError:
    _crc32c_value = None
    _crc32c_extend = None

CHECKSUM_IMPL = "crc32c" if _crc32c_value is not None else "crc32"


def _crc_buffer(data):
    """Adapt a bytes-like object for the crc32c C extension, which only
    accepts read-only buffers (bytes) — or ndarrays, whose buffer
    export it happens to take. Wrapping writable buffers (bytearray,
    shm memoryviews) in a zero-copy ndarray view keeps the data-plane
    seams digesting in place instead of paying a copy per chunk."""
    if type(data) is bytes:
        return data
    try:
        import numpy as np

        return np.frombuffer(data, dtype=np.uint8)
    except (ImportError, ValueError, BufferError):
        return bytes(data)


def checksum(data) -> int:
    """Digest of a bytes-like object (bytes/bytearray/contiguous
    memoryview). The one digest the whole plane carries — always a
    uint32, so the trailer/spill-header formats are backend-agnostic.
    Non-bytes buffers ride a zero-copy ndarray view into the C
    extension (see ``_crc_buffer``), so shm slices digest in place."""
    if _crc32c_value is not None:
        return _crc32c_extend(0, _crc_buffer(data))
    return zlib.crc32(data) & 0xFFFFFFFF


def checksum_update(state: int, data) -> int:
    """Extend a running digest with the next chunk of a stream; start
    from ``state=0`` and the final state equals ``checksum(whole)``.
    This is the fused-crc primitive: the chunk-tree receive path calls
    it on each slice right after ``recv_into`` lands it in the
    segment, while the bytes are still cache-hot, so the whole-object
    digest costs one warm pass fused into the copy instead of a second
    cold traversal at assembly (the store-put fusion, extended to the
    streaming seams)."""
    if _crc32c_value is not None:
        return _crc32c_extend(state, _crc_buffer(data))
    return zlib.crc32(data, state) & 0xFFFFFFFF


def enabled() -> bool:
    from ray_tpu_torch._private.config import Config

    return Config.instance().integrity_enabled


def verify_on_get() -> bool:
    from ray_tpu_torch._private.config import Config

    cfg = Config.instance()
    return cfg.integrity_enabled and cfg.integrity_verify_on_get


def verify_shm_reads() -> bool:
    """Whether same-host shm fast-path reads re-verify their bytes.
    Default on since the data-plane pipeline — see the
    ``integrity_verify_shm_reads`` knob: segment adoption verifies by
    an O(1) trailer-digest compare and the copying paths fuse a
    hardware crc32c into the copy pass, so the verify that used to
    rival the transfer cost itself is now within noise. The trailer
    always rides the segment, so the knob toggles with no format
    change."""
    from ray_tpu_torch._private.config import Config

    cfg = Config.instance()
    return cfg.integrity_enabled and cfg.integrity_verify_shm_reads


def record_corruption(seam: str, discarded: bool = True) -> None:
    """Count a detected corruption (and, usually, the discarded
    replica) in the Prometheus registry."""
    from ray_tpu_torch.observability.metrics import (
        corrupt_replicas_discarded,
        objects_corruption_detected,
    )

    objects_corruption_detected.inc(tags={"seam": seam})
    if discarded:
        corrupt_replicas_discarded.inc()


def verify(data, crc: Optional[int], seam: str,
           object_id: bytes = b"") -> None:
    """Verify ``data`` against ``crc``; raises
    :class:`~ray_tpu_torch.exceptions.ObjectCorruptedError` on mismatch
    (after counting it). No-op when the plane is off or the writer
    recorded no digest (``crc is None``)."""
    if crc is None or not enabled():
        return
    actual = checksum(data)
    if actual != crc:
        from ray_tpu_torch.exceptions import ObjectCorruptedError

        record_corruption(seam)
        raise ObjectCorruptedError(
            object_id.hex() if object_id else "", seam,
            f"object {object_id.hex()[:16] or '?'} failed checksum "
            f"verification at seam {seam!r} "
            f"(expected {crc:#010x}, got {actual:#010x}); "
            f"corrupt replica discarded")
    from ray_tpu_torch.observability.metrics import integrity_bytes_verified

    integrity_bytes_verified.inc(len(data))


def checksum_value(value) -> Optional[int]:
    """Digest of a buffer-typed in-process value (bytes, bytearray,
    contiguous ndarray, ...), or None for values with no stable byte
    representation — the in-process store holds live objects by
    reference, so only buffer values can carry a put-time digest
    without a serialization pass."""
    if isinstance(value, (bytes, bytearray)):
        return checksum(value)
    try:
        mv = memoryview(value)
    except TypeError:
        return None
    try:
        if not mv.contiguous:
            return None
        return checksum(mv.cast("B"))
    finally:
        mv.release()


# ----------------------------------------------------- spill-file header
# Layout: 4-byte magic | 1 flag byte (bit0 is_error, bit1 has_crc) |
# 4-byte big-endian crc32 | payload. Both store tiers write it; restore
# and orphan-reclaim verify it. (The pre-integrity layout was a single
# flag byte; spill files never outlive the code that wrote them except
# through the explicit orphan-reclaim path, which requires the header.)

SPILL_MAGIC = b"RTIC"
_SPILL = struct.Struct(">4sBI")
SPILL_HEADER_SIZE = _SPILL.size
_F_IS_ERROR = 0x01
_F_HAS_CRC = 0x02


def pack_spill_header(is_error: bool, crc: Optional[int]) -> bytes:
    flags = (_F_IS_ERROR if is_error else 0) | (
        _F_HAS_CRC if crc is not None else 0)
    return _SPILL.pack(SPILL_MAGIC, flags, crc or 0)


def parse_spill(raw) -> Tuple[bool, memoryview, Optional[int]]:
    """(is_error, payload_view, crc_or_None) from a spill file's bytes.
    Raises ValueError for files too short / wrong magic (a torn header
    IS corruption — the caller treats it like a failed digest)."""
    view = memoryview(raw)
    if len(view) < SPILL_HEADER_SIZE:
        raise ValueError("spill file shorter than its header")
    magic, flags, crc = _SPILL.unpack(bytes(view[:SPILL_HEADER_SIZE]))
    if magic != SPILL_MAGIC:
        raise ValueError(f"bad spill magic {magic!r}")
    has_crc = bool(flags & _F_HAS_CRC)
    return (bool(flags & _F_IS_ERROR), view[SPILL_HEADER_SIZE:],
            crc if has_crc else None)


# ----------------------------------------------------- shm entry trailer
# A writer that creates a shm entry with integrity on allocates
# logical_size + TRAILER_SIZE and appends magic+crc after the payload.
# Readers that know the logical size slice it off (and can verify);
# readers that don't (loads_flat) ignore trailing bytes by design.

TRAILER_MAGIC = b"RTIC"
_TRAILER = struct.Struct(">4sI")
TRAILER_SIZE = _TRAILER.size


def pack_trailer(crc: int) -> bytes:
    return _TRAILER.pack(TRAILER_MAGIC, crc)


def split_shm(buf, logical_size: int):
    """Interpret a pinned shm entry buffer of a ``logical_size``-byte
    object: returns ``(payload_view, crc_or_None)``, or ``(None,
    None)`` when the entry's length matches neither the bare nor the
    trailer-bearing layout (a stale or foreign entry)."""
    n = len(buf)
    if n == logical_size:
        return memoryview(buf)[:logical_size], None
    if n == logical_size + TRAILER_SIZE:
        magic, crc = _TRAILER.unpack(bytes(buf[logical_size:]))
        if magic == TRAILER_MAGIC:
            return memoryview(buf)[:logical_size], crc
    return None, None


def snapshot() -> dict:
    """This process's integrity counters — rides raylet heartbeats into
    ``cluster_view`` and prints in ``cli.py status``."""
    from ray_tpu_torch.observability.metrics import get_metric

    def total(name: str) -> float:
        m = get_metric(name)
        return sum(m.series().values()) if m is not None else 0.0

    return {
        "corruption_detected": total("ray_tpu_objects_corruption_detected"),
        "corrupt_replicas_discarded": total(
            "ray_tpu_corrupt_replicas_discarded"),
        "bytes_verified": total("ray_tpu_integrity_bytes_verified"),
    }
