"""Tiered node-local object store for the process tier — the plasma
equivalent, with the properties the reference store has and a flat dict
does not (reference: src/ray/object_manager/plasma/{object_lifecycle_
manager.h, eviction_policy.h:160, create_request_queue.cc} and
src/ray/raylet/local_object_manager.h:37,89):

- **Three storage tiers.** Small objects live in the Python heap;
  objects >= ``shm_min_bytes`` live in the node's native shared-memory
  segment (``_native/shm_store.cpp``) so same-host peers and workers can
  read them without a TCP hop; spilled objects live as files under the
  spill directory.
- **Capacity is enforced on put** (an unbounded `put` that only
  appended was the object plane's largest gap). When a put would
  exceed capacity the store reclaims, cheapest first: LRU *replica*
  copies are dropped outright (they exist on another node — the
  equivalent of plasma's LRU eviction of unpinned objects), then LRU
  *primary* copies are spilled to disk (local_object_manager.h:89
  SpillObjects). An object bigger than the whole store falls back
  directly to disk (plasma's fallback allocation).
- **Create backpressure.** Reclamation happens synchronously inside the
  putting call, so a producer that outruns the store pays the spill IO
  itself — the process-tier analogue of plasma's create-request queue,
  which parks creates until space exists (create_request_queue.cc).
- **Transparent restore.** A get/serve of a spilled object reads it back
  from disk (and re-admits it through the same capacity gate).
- **Replica-drop notification.** Dropping a replica invalidates its GCS
  location entry; the store queues the id and a background flusher
  deregisters it, so eviction never blocks on a GCS round trip.

Shm entries are kept *pinned* (refcount >= 1) for their in-memory
lifetime so the C store's own LRU eviction can never silently drop a
primary copy out from under the Python-level accounting; eviction and
spill decisions all happen here, where primariness is known.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
import shutil
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.cluster import integrity
from ray_tpu_torch.exceptions import ObjectCorruptedError

logger = logging.getLogger(__name__)

_MEM, _SHM, _DISK = "mem", "shm", "disk"


_attach_lock = threading.Lock()
_attach_cache: Dict[str, object] = {}


def attach_shm(path: str):
    """Attach (and cache, process-wide) a peer's shm segment for
    same-host reads. Returns None when the segment is unreachable —
    the path not existing is the same-host test itself (/dev/shm files
    are host-local). Readers copy under the C store's process-shared
    mutex, so a concurrent delete by the owner cannot tear the read."""
    with _attach_lock:
        seg = _attach_cache.get(path)
        if seg is not None:
            return seg
        if not os.path.exists(path):
            return None
        try:
            from ray_tpu_torch._native.shm_store import ShmStore

            seg = ShmStore.open(path)
        except Exception:
            return None
        _attach_cache[path] = seg
        return seg


def sweep_stale_segments(min_age_s: Optional[float] = None) -> int:
    """Unlink shm segments (and spill dirs) whose creating process is
    dead. Segment files are named ``ray_tpu_torch_store_<pid>_<token>``
    (the JAX package's, ``ray_tpu_store_...``, are its own to sweep); a
    SIGKILLed raylet (chaos tests kill nodes by design, and the OOM
    killer is real) never reaches its unlink, and the leaked tmpfs
    pages are RESIDENT RAM — 279 leaked segments once held 125 GiB of
    a host and OOM-killed later raylets at boot. Plasma's analogue is its stale-session
    sweep. Unlinking while a live consumer still maps the file is safe
    (the mapping persists until munmap). Returns the number removed.

    Only entries whose mtime is older than ``min_age_s`` (default:
    Config.byte_store_sweep_min_age_s, a few minutes) are removed: the
    dead-pid check alone is not sufficient proof of staleness — a
    legacy pid-less spill dir (``ray_tpu_torch_spill_<rand8>``) can parse an
    all-digit random suffix as a pid, and a recycled pid maps a LIVE
    process onto a dead owner's name — in either miss the victim is a
    running process's spill data. Age covers both: an actively-used
    spill dir keeps a fresh mtime (entries are created/removed in it),
    and a just-booted recycled-pid store is younger than the threshold,
    while a genuinely leaked segment only ever gets older."""
    if min_age_s is None:
        from ray_tpu_torch._private.config import Config

        min_age_s = Config.instance().byte_store_sweep_min_age_s
    # age is measured against filesystem st_mtime values, which are
    # wall-clock by definition
    now = time.time()  # raycheck: disable=RC02
    removed = 0
    # anchored patterns: segment files are
    # ray_tpu_torch_store_<pid>_<token>, spill dirs
    # ray_tpu_torch_spill_<pid> (ByteStore) or
    # ray_tpu_torch_spill_<pid>_<rand> (in-process mkdtemp). An unanchored
    # match could misparse a pid-less random suffix as a pid and rmtree
    # a LIVE store's spilled objects
    for base, pat in (
            ("/dev/shm", re.compile(r"^ray_tpu_torch_store_(\d+)_")),
            (tempfile.gettempdir(),
             re.compile(r"^ray_tpu_torch_(?:store|spill)_(\d+)(?:_|$)"))):
        try:
            names = os.listdir(base)
        except OSError:
            continue
        for name in names:
            m = pat.match(name)
            if not m:
                continue
            pid = int(m.group(1))
            try:
                os.kill(pid, 0)
                continue  # owner alive
            except ProcessLookupError as e:
                # owner is gone: this entry is a sweep candidate
                logger.debug("sweep: owner pid %d of %s is dead: %r",
                             pid, name, e)
            except PermissionError:
                continue  # alive, other user
            except (OverflowError, OSError):
                # a pid-like number too large for the C long (stray
                # file): skip the entry, never abort the whole sweep —
                # a dead sweep silently reintroduces the leak
                continue
            path = os.path.join(base, name)
            try:
                if now - os.stat(path).st_mtime < min_age_s:
                    continue  # too young to be provably stale
            except OSError:
                continue  # vanished under us (concurrent sweep)
            try:
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.unlink(path)
                removed += 1
            except OSError as e:
                # permissions or a concurrent sweep won the unlink
                logger.debug("sweep: removing %s failed: %r", path, e)
    return removed


def shm_key(object_id: bytes) -> bytes:
    """20-byte shm-store key for an arbitrary-length object id.
    Hashed (not truncated): structured ids — e.g. ObjectID's
    task-id-prefix layout (_private/ids.py) — share long prefixes, and
    truncation would collide every return of one task."""
    return hashlib.blake2b(object_id, digest_size=20).digest()


class _Entry:
    __slots__ = ("is_error", "where", "buf", "size", "primary", "path",
                 "pins", "crc", "seg", "seg_path")

    def __init__(self, is_error: bool, where: str, buf, size: int,
                 primary: bool, path: Optional[str] = None,
                 crc: Optional[int] = None, seg=None,
                 seg_path: Optional[str] = None):
        self.is_error = is_error
        self.where = where
        self.buf = buf          # bytes (mem) | pinned memoryview (shm)
        self.size = size
        self.primary = primary
        self.path = path        # spill file (disk)
        # integrity plane: crc32 computed once at creation; rides every
        # transfer of this object and is verified at each seam
        self.crc = crc
        # data-plane adoption: for a same-host replica that is a shared
        # MAPPING of a peer's sealed segment entry (not a copy), the
        # attached peer segment holding our refcount pin, and its path
        # (so offers/zero-copy reads of this object point readers at
        # the segment that actually holds the bytes). None = the entry
        # lives in this store's own segment/heap.
        self.seg = seg
        self.seg_path = seg_path
        # pin count: >0 means some task is using this object as an
        # argument right now — reclaim must not evict or spill it
        # (reference: DependencyManager pins task args; plasma pins via
        # client refcount, object_lifecycle_manager.h)
        self.pins = 0


class ReceiveHandle:
    """An in-progress streamed receive: the object's final segment
    bytes, preallocated at ``push_begin`` time so every chunk is copied
    ONCE — from the socket straight to its final shm offset via
    ``recv_into`` on a slice of :attr:`view` (readinto the preallocated
    segment; the reference ObjectManager's chunked receive, minus its
    intermediate chunk buffers). Not an entry yet: invisible to
    lookups until :meth:`ByteStore.seal_receive` admits it."""

    __slots__ = ("object_id", "size", "is_error", "crc", "view", "shm",
                 "_buf", "_trailer", "landed", "crc_state", "t0",
                 "t_last")

    def __init__(self, object_id: bytes, size: int, is_error: bool,
                 crc: Optional[int]):
        self.object_id = object_id
        self.size = size
        self.is_error = is_error
        self.crc = crc          # sender's whole-object digest (begin)
        self.view = None        # writable payload view (chunks land here)
        self.shm = False
        self._buf = None        # full allocation incl. trailer space
        self._trailer = 0
        self.landed = 0         # coverage: bytes landed so far
        self.crc_state = 0      # running fused digest of landed bytes
        self.t0 = time.monotonic()
        self.t_last = self.t0   # staleness: last progress timestamp


class ByteStore:
    """Node-local object store holding sealed, immutable pickled
    payloads, LRU-ordered. Thread-safe. See module docstring."""

    def __init__(self, capacity: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 shm_min_bytes: int = 64 * 1024,
                 use_shm: bool = True,
                 on_replica_dropped: Optional[Callable[[bytes], None]] = None):
        from ray_tpu_torch._private.config import Config

        cfg = Config.instance()
        # every store boot reclaims segments orphaned by SIGKILLed
        # owners first — their tmpfs pages are resident RAM and a few
        # leaked GiB-scale segments can OOM this very boot's prefault
        try:
            n = sweep_stale_segments()
            if n:
                logger.info("swept %d stale shm segments/spill dirs", n)
        except Exception as e:  # the sweep must never block a boot
            logger.debug("stale-segment sweep at boot failed: %r", e)
        self.capacity = capacity or cfg.object_store_memory
        self.shm_min_bytes = shm_min_bytes
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        # deleted-while-pinned entries: invisible to lookups, bytes kept
        # until the last unpin (plasma delete-while-in-use semantics)
        self._condemned: Dict[bytes, _Entry] = {}
        self.total_bytes = 0        # mem + shm tiers (disk doesn't count)
        self.num_spilled = 0
        self.num_replicas_dropped = 0
        self.num_restored = 0
        self._on_replica_dropped = on_replica_dropped
        self._spill_dir = spill_dir or (
            cfg.spill_directory
            or os.path.join(tempfile.gettempdir(),
                            f"ray_tpu_torch_spill_{os.getpid()}"))
        self._shm = None
        self.shm_path: Optional[str] = None
        if use_shm:
            try:
                from ray_tpu_torch._native.shm_store import ShmStore

                # headroom beyond `capacity`: the C store's entry table
                # + allocator rounding, plus room for TRANSIENT transfer
                # buffers (worker<->raylet out-of-band pickle-5 buffers
                # and in-flight worker result writes live in the same
                # segment but outside this store's accounting)
                headroom = max(64 * 1024 * 1024, self.capacity // 4)
                self._shm = ShmStore(capacity=self.capacity + headroom
                                     + 16 * 1024 * 1024)
                self.shm_path = self._shm.path
            except Exception as e:  # native unavailable: mem-only
                logger.info("shm store unavailable (%s); "
                            "using heap tier only", e)
        # integrity plane: corrupt replicas discarded at a verify seam
        # and orphan spill files re-adopted (or dropped) at boot
        self.num_corrupt_dropped = 0
        self.num_orphans_adopted = 0
        # data-plane pipeline: in-progress streamed receives (chunks
        # landing straight in their final segment bytes) and same-host
        # segment adoptions (replica = shared mapping, zero bytes moved)
        self._receiving: Dict[bytes, ReceiveHandle] = {}
        self.num_shm_adopts = 0
        self.num_rx_aborted = 0
        # boot-time orphan-spill reclaim: only when the spill dir is
        # EXPLICIT (ctor arg or Config.spill_directory) — sharing a
        # directory across incarnations is then intentional, and a
        # restarted raylet re-serves what its predecessor spilled
        # instead of stranding it. The default pid-derived dir is
        # always fresh, so adoption there would only cross-talk
        # same-process stores in tests.
        if spill_dir or cfg.spill_directory:
            try:
                self._adopt_orphan_spills()
            except Exception as e:  # adoption must never block a boot
                logger.warning("orphan spill reclaim failed: %r", e)
        from ray_tpu_torch.scheduler.pull_manager import PullManager

        self.pull_manager = PullManager(self.capacity)

    def _adopt_orphan_spills(self) -> None:
        """Re-adopt spill files a previous incarnation left in the
        (explicit) spill dir — verifying each file's header digest
        first and DROPPING corrupt ones (counted) instead of re-serving
        bytes a dying raylet half-wrote. Files are named by object-id
        hex, so the id is recoverable; ``.tmp`` leftovers of torn
        ``os.replace`` writes are removed outright."""
        try:
            names = os.listdir(self._spill_dir)
        except OSError:
            return
        for name in sorted(names):
            path = os.path.join(self._spill_dir, name)
            if name.endswith(".tmp"):
                try:
                    os.unlink(path)
                except OSError as e:
                    logger.debug("removing torn spill tmp %s failed: "
                                 "%r", name, e)
                continue
            try:
                object_id = bytes.fromhex(name)
            except ValueError:
                continue  # not a spill file of ours
            try:
                with open(path, "rb") as f:
                    raw = f.read()
                is_error, payload, crc = integrity.parse_spill(raw)
                if crc is not None and integrity.enabled():
                    integrity.verify(payload, crc, "orphan_reclaim",
                                     object_id)
                elif crc is None:
                    # headerless-crc file (written with the plane off):
                    # unverifiable — adopting it would re-serve bytes
                    # nobody can vouch for
                    raise ValueError("spill file carries no digest")
            except ObjectCorruptedError:
                self.num_corrupt_dropped += 1
                try:
                    os.unlink(path)
                except OSError as e:
                    logger.debug("unlinking corrupt orphan spill %s "
                                 "failed: %r", name[:16], e)
                logger.warning("orphan spill %s failed its digest; "
                               "dropped", name[:16])
                continue
            except (OSError, ValueError) as e:
                # torn header / unreadable file: same treatment as a
                # failed digest — drop, never re-serve
                integrity.record_corruption("orphan_reclaim")
                self.num_corrupt_dropped += 1
                try:
                    os.unlink(path)
                except OSError as err:
                    logger.debug("unlinking unreadable orphan spill "
                                 "%s failed: %r", name[:16], err)
                logger.warning("orphan spill %s unreadable (%r); "
                               "dropped", name[:16], e)
                continue
            with self._cv:
                if object_id in self._entries:
                    continue
                self._entries[object_id] = _Entry(
                    is_error, _DISK, None, len(payload), True, path,
                    crc=crc)
                self.num_orphans_adopted += 1
                self._cv.notify_all()

    # ------------------------------------------------------------- queries
    def entries(self) -> List[Tuple[bytes, int]]:
        """(object_id, size) of every resident object (all tiers — a
        spilled object is still restorable here), for the re-report
        after a GCS restart wipes the location directory."""
        with self._lock:
            return [(oid, e.size) for oid, e in self._entries.items()]

    def contains(self, object_id: bytes) -> bool:
        with self._lock:
            return object_id in self._entries

    def info(self, object_id: bytes) -> Optional[dict]:
        """Tier/size metadata for transfer negotiation, or None."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                return None
            return {"size": e.size, "is_error": e.is_error,
                    "where": e.where, "crc": e.crc,
                    "shm_path": self._shm_path_of(e)}

    def stats(self) -> dict:
        from ray_tpu_torch.observability.metrics import object_store_bytes

        with self._lock:
            object_store_bytes.set(self.total_bytes)
            by_tier: Dict[str, int] = {_MEM: 0, _SHM: 0, _DISK: 0}
            for e in self._entries.values():
                by_tier[e.where] += 1
            return {"num_objects": len(self._entries),
                    "total_bytes": self.total_bytes,
                    "capacity": self.capacity,
                    "tiers": by_tier,
                    "num_spilled": self.num_spilled,
                    "num_restored": self.num_restored,
                    "num_replicas_dropped": self.num_replicas_dropped,
                    "num_corrupt_dropped": self.num_corrupt_dropped,
                    "num_orphans_adopted": self.num_orphans_adopted,
                    "num_shm_adopts": self.num_shm_adopts,
                    "num_rx_aborted": self.num_rx_aborted,
                    "num_receiving": len(self._receiving),
                    "shm": self._shm.stats() if self._shm else None}

    # ----------------------------------------------------------------- put
    def put(self, object_id: bytes, payload, is_error: bool = False,
            primary: bool = True, crc: Optional[int] = None) -> bool:
        """Store a sealed payload. Returns False if already present.
        ``primary=False`` marks a replica pulled from a peer — the
        cheapest thing to evict under pressure. ``crc`` is the
        integrity digest a verified transfer seam already holds; when
        omitted it is computed once, at creation, INSIDE the admit —
        fused with the tier copy so the digest reads bytes the memcpy
        just made cache-hot instead of a second cold traversal (the
        integrity plane's compute-once contract, ROADMAP 3a)."""
        size = len(payload)
        with self._cv:
            if object_id in self._entries:
                return False
            if size > self.capacity:
                # fallback allocation: bigger than the whole store goes
                # straight to disk (plasma_allocator.cc fallback mmap)
                entry = self._spill_payload(object_id, payload, is_error,
                                            primary, crc)
            else:
                self._reclaim_locked(size)
                entry = self._admit_locked(object_id, payload, is_error,
                                           primary, crc)
            self._entries[object_id] = entry
            self._cv.notify_all()
        return True

    def _admit_locked(self, object_id: bytes, payload, is_error: bool,
                      primary: bool, crc: Optional[int] = None) -> _Entry:
        size = len(payload)
        # digest-once, fused with the admit copy: a caller-supplied crc
        # (a verified transfer seam's) is adopted verbatim; otherwise it
        # is computed below on the bytes the tier copy just touched, so
        # payload is traversed once through cache instead of one cold
        # digest pass plus one cold copy pass
        want_crc = crc is None and integrity.enabled()
        if self._shm is not None and size >= self.shm_min_bytes:
            try:
                key = shm_key(object_id)
                # integrity trailer: the segment entry carries
                # payload + magic + crc, so ANY same-host reader
                # (peer raylet, driver) can verify the bytes it copies;
                # the logical size excludes the trailer
                trailer_len = (integrity.TRAILER_SIZE
                               if crc is not None or want_crc else 0)
                buf = self._shm.create(key, size + trailer_len)
                buf[:size] = payload
                if want_crc:
                    crc = integrity.checksum(
                        payload if type(payload) is bytes else buf[:size])
                if trailer_len:
                    buf[size:] = integrity.pack_trailer(crc)
                self._shm.seal(key)
                pinned = self._shm.get_buffer(key)  # refcount 1: the C
                # store's own LRU can never evict it behind our back
                self.total_bytes += size
                return _Entry(is_error, _SHM, pinned[:size], size,
                              primary, crc=crc)
            except (MemoryError, KeyError, OSError) as e:
                # fragmentation or segment oddity: heap fallback
                logger.debug("shm admit of %s (%d bytes) fell back to "
                             "heap: %r", object_id.hex()[:8], size, e)
        data = bytes(payload)  # no-op when payload is already bytes
        if want_crc:
            crc = integrity.checksum(data)
        self.total_bytes += size
        return _Entry(is_error, _MEM, data, size, primary, crc=crc)

    def _reclaim_locked(self, want: int) -> None:
        """Free memory until ``want`` more bytes fit under capacity:
        drop LRU replicas first, then spill LRU primaries. Pinned
        entries are untouchable — when everything is pinned, the put
        proceeds over capacity (a bounded transient: pins are held only
        for the duration of one task's argument use, and plasma makes
        the same over-commit choice with its fallback allocations
        rather than deadlocking the create queue)."""
        if self.total_bytes + want <= self.capacity:
            return
        # pass 1: replicas (another node has the primary; re-pullable)
        for oid in [o for o, e in self._entries.items()
                    if not e.primary and e.where != _DISK
                    and e.pins == 0]:
            if self.total_bytes + want <= self.capacity:
                return
            self._drop_tier_locked(oid)
            del self._entries[oid]
            self.num_replicas_dropped += 1
            if self._on_replica_dropped is not None:
                self._on_replica_dropped(oid)
        # pass 2: spill primaries, LRU first
        for oid in [o for o, e in self._entries.items()
                    if e.where != _DISK and e.pins == 0]:
            if self.total_bytes + want <= self.capacity:
                return
            e = self._entries[oid]
            payload = self._payload_locked(e)
            self._drop_tier_locked(oid)
            self._entries[oid] = self._spill_payload(
                oid, payload, e.is_error, e.primary, e.crc)

    def _spill_payload(self, object_id: bytes, payload, is_error: bool,
                       primary: bool, crc: Optional[int] = None) -> _Entry:
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir, object_id.hex())
        tmp = path + ".tmp"
        if crc is None and integrity.enabled():
            crc = integrity.checksum(payload)
        # seeded fault hook: the `corrupt` rule kind flips a byte of the
        # bytes WRITTEN (the header digest reflects the true payload),
        # modeling at-rest spill corruption deterministically
        from ray_tpu_torch.cluster import fault_plane as _fault

        plane = _fault.get_plane()
        if plane is not None:
            fault = plane.decide("spill", "byte_store", object_id.hex())
            if fault is not None and fault["action"] == "corrupt":
                payload = _fault.apply_corruption(payload, fault)
        with open(tmp, "wb") as f:
            f.write(integrity.pack_spill_header(is_error, crc))
            f.write(payload)
        os.replace(tmp, path)
        self.num_spilled += 1
        return _Entry(is_error, _DISK, None, len(payload), primary, path,
                      crc=crc)

    def _drop_tier_locked(self, object_id: bytes,
                          entry: Optional[_Entry] = None) -> None:
        """Release the in-memory bytes of an entry (mem or shm tier)."""
        e = entry if entry is not None else self._entries[object_id]
        if e.where == _SHM:
            key = shm_key(object_id)
            try:
                e.buf.release()  # the memoryview slice
            except AttributeError as err:
                # defensive: a shm entry's buf is always a memoryview
                logger.debug("entry %s buffer lacks release(): %r",
                             object_id.hex()[:8], err)
            if e.seg is not None:
                # adopted mapping of a peer's segment: drop OUR pin only
                # — the owner (whose deferred delete our refcount holds
                # open) garbage-collects the block; deleting a foreign
                # key is not ours to do
                try:
                    e.seg.release(key)
                except Exception as err:
                    logger.debug("releasing adopted mapping of %s "
                                 "failed: %r", object_id.hex()[:8], err)
            else:
                self._shm.release(key)
                self._shm.delete(key)
        if e.where in (_MEM, _SHM) and e.seg is None:
            # adopted entries never counted: their bytes live in the
            # OWNER's segment (one physical copy per host)
            self.total_bytes -= e.size
        e.buf = None

    def _read_spill_fused(self, e: _Entry, object_id: bytes) -> bytes:
        """Restore a spill file with its digest FUSED into the read:
        each ``readinto`` slice is folded into the running crc while
        still cache-hot (``integrity.checksum_update``), so a restore
        costs one pass through the payload instead of a read pass plus
        a cold verify pass — the put-side fusion, applied to the
        spill-restore seam. Raises ObjectCorruptedError on mismatch
        (counted by the caller), ValueError on a torn layout."""
        with open(e.path, "rb") as f:
            head = f.read(integrity.SPILL_HEADER_SIZE)
            _, _, crc = integrity.parse_spill(head)
            buf = bytearray(e.size)
            mv = memoryview(buf)
            state, off = 0, 0
            check = crc is not None and integrity.enabled()
            while off < e.size:
                n = f.readinto(mv[off:off + (4 << 20)])
                if not n:
                    raise ValueError(
                        f"spill file truncated at {off}/{e.size}")
                if check:
                    state = integrity.checksum_update(
                        state, mv[off:off + n])
                off += n
            if f.read(1):
                raise ValueError("spill file longer than its header "
                                 "claims")
        if check and state != crc:
            integrity.record_corruption("spill_restore")
            raise ObjectCorruptedError(
                object_id.hex(), "spill_restore",
                f"object {object_id.hex()[:16]} failed checksum "
                f"verification at seam 'spill_restore' "
                f"(expected {crc:#010x}, got {state:#010x}); "
                f"corrupt replica discarded")
        return bytes(buf)

    def _payload_locked(self, e: _Entry):
        if e.where == _DISK:
            with open(e.path, "rb") as f:
                raw = f.read()
            _, payload, _ = integrity.parse_spill(raw)
            return bytes(payload)
        if e.where == _SHM:
            return bytes(e.buf)
        return e.buf

    # ----------------------------------------------------------------- get
    def get(self, object_id: bytes) -> Optional[Tuple[bool, bytes]]:
        """Returns (is_error, payload) or None. A spilled object is
        restored from disk (and re-admitted through the capacity gate,
        so a restore can itself spill something colder). A restore
        whose bytes fail the spill header's digest raises
        :class:`~ray_tpu_torch.exceptions.ObjectCorruptedError` and DISCARDS
        the replica — the caller re-pulls from another holder or falls
        through to lineage reconstruction instead of serving garbage."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None:
                return None
            self._entries.move_to_end(object_id)  # LRU touch
            if e.where != _DISK:
                return (e.is_error,
                        bytes(e.buf) if e.where == _SHM else e.buf)
            try:
                payload = self._read_spill_fused(e, object_id)
            except (ObjectCorruptedError, OSError, ValueError) as err:
                # failed digest, torn header, or vanished file: the
                # replica is unservable — discard it (count a digest
                # failure; I/O errors are their own story)
                del self._entries[object_id]
                self.num_corrupt_dropped += 1
                try:
                    os.unlink(e.path)
                except OSError as unlink_err:
                    logger.debug("unlinking corrupt spill %s failed: "
                                 "%r", e.path, unlink_err)
                if isinstance(err, ObjectCorruptedError):
                    raise
                integrity.record_corruption("spill_restore")
                raise ObjectCorruptedError(
                    object_id.hex(), "spill_restore",
                    f"spill replica of {object_id.hex()[:16]} "
                    f"unreadable: {err!r}") from err
            self.num_restored += 1
            if e.size <= self.capacity:
                path = e.path
                self._reclaim_locked(e.size)
                self._entries[object_id] = self._admit_locked(
                    object_id, payload, e.is_error, e.primary, e.crc)
                try:
                    os.unlink(path)
                except OSError as err:
                    # orphaned spill file; the dead-owner sweep or
                    # delete() retires it later
                    logger.debug("removing spill file %s after restore "
                                 "failed: %r", path, err)
            return (e.is_error, payload)

    def pin(self, object_id: bytes) -> Optional[dict]:
        """Pin + return tier metadata in one critical section, WITHOUT
        reading the payload — the zero-copy arg path pins the entry and
        hands the worker a segment key instead of bytes. Returns None
        if absent. Pair with unpin()."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                return None
            e.pins += 1
            self._entries.move_to_end(object_id)
            return {"size": e.size, "is_error": e.is_error,
                    "where": e.where, "crc": e.crc,
                    "shm_path": self._shm_path_of(e)}

    def view_and_pin(self, object_id: bytes
                     ) -> Optional[Tuple[bool, memoryview, Optional[int]]]:
        """Pin + return ``(is_error, payload_view, crc)`` WITHOUT
        copying — the chunked-send source path streams straight out of
        the segment (or heap bytes) instead of bouncing GiB-scale
        payloads through ``get()``'s copy. A spilled entry is restored
        first (one verified pass) and the view taken over the restored
        bytes. Pair with unpin(); the pin keeps reclaim off the entry
        while chunks are in flight."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is not None and e.where != _DISK:
                e.pins += 1
                self._entries.move_to_end(object_id)
                return e.is_error, memoryview(e.buf), e.crc
        got = self.get(object_id)  # disk: restore (re-admits + verifies)
        if got is None:
            return None
        with self._cv:
            e = self._entries.get(object_id)
            if e is None:
                return None
            e.pins += 1
            if e.where != _DISK and e.buf is not None:
                return e.is_error, memoryview(e.buf), e.crc
            # stayed on disk (bigger than the store): the restored copy
            # got[1] is heap-held by us alone; the pin is still taken so
            # unpin stays symmetrical
            return e.is_error, memoryview(got[1]), e.crc

    def _shm_path_of(self, e: _Entry) -> Optional[str]:
        """Path of the segment that actually holds an shm-tier entry's
        bytes: this store's own segment normally, the OWNER's for an
        adopted mapping — so zero-copy readers and outward offers always
        name a segment where ``shm_key(oid)`` resolves."""
        if e.where != _SHM:
            return None
        return e.seg_path if e.seg_path is not None else self.shm_path

    def adopt_shm(self, object_id: bytes, size: int,
                  is_error: bool = False, primary: bool = True) -> bool:
        """Adopt an object a worker process already created+sealed in
        this node's segment under shm_key(object_id) — the plasma write
        path (workers create directly in the store; the raylet only
        pins). No payload bytes cross any process boundary."""
        if self._shm is None:
            return False
        key = shm_key(object_id)
        with self._cv:
            if object_id in self._entries:
                # already resident (a retry raced us): the worker-made
                # copy is an orphan unless the resident entry itself is
                # the shm entry under this key
                if self._entries[object_id].where != _SHM:
                    try:
                        self._shm.delete(key)
                    except Exception as e:
                        logger.debug("deleting orphaned worker copy of "
                                     "%s failed: %r",
                                     object_id.hex()[:8], e)
                return True
            pinned = self._shm.get_buffer(key)  # refcount pin
            if pinned is None:
                return False
            # integrity: a worker that wrote the entry with the plane
            # on appended a crc trailer — verify the payload BEFORE
            # adopting it as this node's primary copy (the seam where a
            # dying worker's half-written result would otherwise enter
            # the store). A length matching neither layout is a stale
            # or foreign entry: refuse it.
            payload_view, crc = integrity.split_shm(pinned, size)
            if payload_view is None:
                self._shm.release(key)
                return False
            if crc is not None:
                try:
                    integrity.verify(payload_view, crc, "adopt_shm",
                                     object_id)
                except ObjectCorruptedError:
                    self.num_corrupt_dropped += 1
                    payload_view.release()
                    self._shm.release(key)
                    try:
                        self._shm.delete(key)
                    except Exception as e:
                        logger.debug("deleting corrupt worker copy of "
                                     "%s failed: %r",
                                     object_id.hex()[:8], e)
                    return False
            self._reclaim_locked(size)
            self.total_bytes += size
            self._entries[object_id] = _Entry(is_error, _SHM,
                                              payload_view, size,
                                              primary, crc=crc)
            self._cv.notify_all()
        return True

    # --------------------------------------- data plane: streamed receive
    def begin_receive(self, object_id: bytes, size: int,
                      is_error: bool = False,
                      crc: Optional[int] = None
                      ) -> Optional[ReceiveHandle]:
        """Open a streamed receive: preallocate the object's FINAL
        bytes (shm segment entry when eligible, heap otherwise) and
        return a :class:`ReceiveHandle` whose ``view`` chunk frames
        ``recv_into`` directly — socket to sealed segment offset in one
        copy, no assembly buffer. Returns None when the object is
        already resident (the push is a duplicate). A half-open receive
        of the same id is superseded (torn sender, re-push won the
        race). The bytes are reserved against capacity from here —
        reclaim runs now, not at seal."""
        with self._cv:
            if object_id in self._entries:
                return None
            old = self._receiving.pop(object_id, None)
            if old is not None:
                self._discard_rx_locked(old)
            h = ReceiveHandle(object_id, size, is_error, crc)
            h._trailer = (integrity.TRAILER_SIZE
                          if crc is not None or integrity.enabled()
                          else 0)
            if (self._shm is not None and size >= self.shm_min_bytes
                    and size <= self.capacity):
                try:
                    key = shm_key(object_id)
                    self._reclaim_locked(size)
                    try:
                        buf = self._shm.create(key, size + h._trailer)
                    except KeyError:
                        # leftover unsealed entry of a torn receive
                        # under this key: unsealed deletes free
                        # immediately (shm_store.cpp delete semantics)
                        self._shm.delete(key)
                        buf = self._shm.create(key, size + h._trailer)
                    h._buf = buf
                    h.view = buf[:size]
                    h.shm = True
                except (MemoryError, KeyError, OSError) as e:
                    logger.debug("shm receive alloc of %s (%d bytes) "
                                 "fell back to heap: %r",
                                 object_id.hex()[:8], size, e)
            if h.view is None:
                h.view = memoryview(bytearray(size))
            self.total_bytes += size
            self._receiving[object_id] = h
            return h

    def seal_receive(self, h: ReceiveHandle, crc: Optional[int] = None,
                     primary: bool = False) -> bool:
        """Admit a completed receive as a resident entry. ``crc`` is
        the receiver's RUNNING digest (``integrity.checksum_update``
        folded over the chunks as they landed — the fused single pass);
        it is checked against the digest the sender declared at begin,
        and on mismatch the receive is torn down and
        :class:`~ray_tpu_torch.exceptions.ObjectCorruptedError` raised.
        Returns False when this receive was superseded meanwhile."""
        final_crc = crc if crc is not None else h.crc
        with self._cv:
            st = self._receiving.get(h.object_id)
            if st is not h:
                return False
            del self._receiving[h.object_id]
            if h.object_id in self._entries:
                # a concurrent pull beat the push: resident wins
                self._discard_rx_locked(h)
                return True
            if (h.crc is not None and crc is not None
                    and crc != h.crc and integrity.enabled()):
                self._discard_rx_locked(h)
                self.num_corrupt_dropped += 1
                integrity.record_corruption("push_receive")
                raise ObjectCorruptedError(
                    h.object_id.hex(), "push_receive",
                    f"streamed receive of {h.object_id.hex()[:16]} "
                    f"failed its end-to-end digest "
                    f"(expected {h.crc:#010x}, got {crc:#010x}); "
                    f"half-assembled replica discarded")
            if h.shm:
                try:
                    key = shm_key(h.object_id)
                    if h._trailer:
                        if final_crc is None:  # safety net: cold pass
                            final_crc = integrity.checksum(h.view)
                        h._buf[h.size:] = integrity.pack_trailer(
                            final_crc)
                    h.view.release()
                    h._buf.release()
                    h.view = h._buf = None
                    self._shm.seal(key)
                    pinned = self._shm.get_buffer(key)
                    entry = _Entry(h.is_error, _SHM, pinned[:h.size],
                                   h.size, primary, crc=final_crc)
                except Exception:
                    self._discard_rx_locked(h)
                    raise
            else:
                data = bytes(h.view)
                h.view = None
                if h.size > self.capacity:
                    entry = self._spill_payload(h.object_id, data,
                                                h.is_error, primary,
                                                final_crc)
                    self.total_bytes -= h.size  # disk doesn't count
                else:
                    entry = _Entry(h.is_error, _MEM, data, h.size,
                                   primary, crc=final_crc)
            self._entries[h.object_id] = entry
            self._cv.notify_all()
        return True

    def abort_receive(self, object_id: bytes) -> bool:
        """Tear down a half-assembled receive (sender died mid-stream,
        a chunk failed its digest, or the stale sweep fired): the
        unsealed segment entry is freed immediately and the reserved
        bytes returned to capacity. Counted. Returns False when no
        receive of this id is open."""
        with self._cv:
            h = self._receiving.pop(object_id, None)
            if h is None:
                return False
            self._discard_rx_locked(h)
            self.num_rx_aborted += 1
        return True

    def sweep_stale_receives(self, max_age_s: float) -> List[bytes]:
        """Abort receives with no chunk progress for ``max_age_s`` —
        the raylet's heartbeat calls this so a sender that vanished
        mid-broadcast cannot strand reserved segment bytes. Returns
        the object ids torn down."""
        now = time.monotonic()
        out: List[bytes] = []
        with self._cv:
            for oid, h in list(self._receiving.items()):
                if now - h.t_last >= max_age_s:
                    del self._receiving[oid]
                    self._discard_rx_locked(h)
                    self.num_rx_aborted += 1
                    out.append(oid)
        return out

    def _discard_rx_locked(self, h: ReceiveHandle) -> None:
        if h.shm:
            for v in (h.view, h._buf):
                try:
                    if v is not None:
                        v.release()
                except Exception as e:
                    logger.debug("releasing receive view of %s failed: "
                                 "%r", h.object_id.hex()[:8], e)
            try:
                # unsealed entries free immediately, writer ref or not
                self._shm.delete(shm_key(h.object_id))
            except Exception as e:
                logger.debug("freeing aborted receive of %s failed: %r",
                             h.object_id.hex()[:8], e)
        h.view = None
        h._buf = None
        self.total_bytes -= h.size

    # --------------------------------------- data plane: segment adoption
    def adopt_remote_shm(self, object_id: bytes, shm_path: str,
                         size: int, is_error: bool = False,
                         crc: Optional[int] = None,
                         primary: bool = False) -> bool:
        """Adopt a same-host peer's sealed segment entry as a local
        replica by MAPPING it, not copying it — the plasma posture of
        one physical object copy per host. The pin rides the segment's
        cross-process refcount, so the owner deleting the object defers
        the free until our release (shm_store.cpp kPendingDelete).
        Verification is O(1): the trailer's structural check plus an
        integer compare of its digest against the offer's — the fused
        put-time digest already vouches for the bytes, so
        ``integrity_verify_shm_reads`` costs nothing on this path.
        Returns False on any failure (caller falls back to the copying
        stream path); a path that doesn't exist is the not-same-host
        test itself."""
        if self._shm is None or shm_path is None:
            return False
        if shm_path == self.shm_path:
            # our own segment: the object is either already ours or
            # adoptable through the worker-write path
            return self.adopt_shm(object_id, size, is_error, primary)
        seg = attach_shm(shm_path)
        if seg is None:
            return False
        key = shm_key(object_id)
        with self._cv:
            if object_id in self._entries:
                return True
            try:
                pinned = seg.get_buffer(key)
            except Exception as e:
                logger.debug("pinning %s in peer segment %s failed: %r",
                             object_id.hex()[:8], shm_path, e)
                return False
            if pinned is None:
                return False
            payload_view, seg_crc = integrity.split_shm(pinned, size)
            if payload_view is None:
                # stale or foreign entry under this key: refuse
                seg.release(key)
                return False
            if seg_crc is not None and crc is not None:
                if seg_crc != crc:
                    # the offer's digest disagrees with the segment
                    # trailer — one of the copies is wrong; refuse
                    # without a byte pass and let recovery re-source
                    integrity.record_corruption("adopt_remote")
                    self.num_corrupt_dropped += 1
                    payload_view.release()
                    seg.release(key)
                    return False
            elif crc is not None and integrity.enabled():
                # trailerless producer: one verified pass before
                # serving a peer's bytes as ours
                try:
                    integrity.verify(payload_view, crc, "adopt_remote",
                                     object_id)
                except ObjectCorruptedError:
                    self.num_corrupt_dropped += 1
                    payload_view.release()
                    seg.release(key)
                    return False
            self._entries[object_id] = _Entry(
                is_error, _SHM, payload_view, size, primary,
                crc=crc if crc is not None else seg_crc,
                seg=seg, seg_path=shm_path)
            self.num_shm_adopts += 1
            self._cv.notify_all()
        return True

    def get_and_pin(self, object_id: bytes
                    ) -> Optional[Tuple[bool, bytes]]:
        """get() + pin in one critical section: the caller is about to
        use the payload as a task argument, and a concurrent put's
        reclaim must not drop it between lookup and use. Pair with
        unpin()."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None:
                return None
            e.pins += 1
        try:
            result = self.get(object_id)
        except BaseException:
            self.unpin(object_id)
            raise
        if result is None:  # deleted between pin and read
            self.unpin(object_id)
        return result

    def unpin(self, object_id: bytes) -> None:
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None:
                if e.pins > 0:
                    e.pins -= 1
                return
            e = self._condemned.get(object_id)
            if e is not None:
                if e.pins > 0:
                    e.pins -= 1
                if e.pins == 0:  # last pin on a deleted entry: free it
                    del self._condemned[object_id]
                    self._finalize_delete_locked(object_id, e)

    def wait(self, object_id: bytes, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while object_id not in self._entries:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def delete(self, object_id: bytes) -> None:
        """Remove an object. A PINNED entry (a task is using it as an
        argument right now) is condemned instead: it stops being
        gettable immediately, but its bytes survive until the last
        unpin — mirroring both the C store's deferred delete and
        plasma's delete-while-in-use rule."""
        with self._lock:
            e = self._entries.pop(object_id, None)
            if e is None:
                return
            if e.pins > 0:
                self._condemned[object_id] = e
                return
            self._finalize_delete_locked(object_id, e)

    def _finalize_delete_locked(self, object_id: bytes,
                                e: _Entry) -> None:
        self._drop_tier_locked(object_id, e)
        if e.where == _DISK and e.path:
            try:
                os.unlink(e.path)
            except OSError as err:
                logger.debug("removing spill file %s on delete of %s "
                             "failed: %r", e.path,
                             object_id.hex()[:8], err)

    def close(self) -> None:
        with self._cv:
            # tear down half-open receives and drop our pins in PEER
            # segments (their owners' deferred deletes are waiting on
            # our release — holding them past close would strand the
            # owner's bytes until process exit)
            for h in self._receiving.values():
                self._discard_rx_locked(h)
            self._receiving.clear()
            for oid in [o for o, e in self._entries.items()
                        if e.seg is not None]:
                self._drop_tier_locked(oid)
                del self._entries[oid]
        if self._shm is not None:
            try:
                self._shm.close(unlink=True)
            except Exception as e:
                # stale-segment sweep reclaims whatever this leaves
                logger.debug("shm segment close failed: %r", e)
            self._shm = None


class PushManager:
    """Outbound push throttle (reference: object_manager/push_manager.h —
    dedup of concurrent pushes of the same object to the same node and a
    cap on chunks in flight).

    ``push`` enqueues (object_id, dest) unless that pair is already
    queued or being sent; at most ``max_inflight`` destination transfers
    run at once, each chunked with at most ``max_chunks_in_flight``
    unacknowledged chunk RPCs (the pipelining knob)."""

    def __init__(self, send_fn: Callable[[bytes, str], None],
                 max_inflight: int = 4,
                 max_queued: Optional[int] = None):
        from ray_tpu_torch._private.config import Config
        from ray_tpu_torch.cluster.threads import ThreadRegistry

        self._send_fn = send_fn
        self._max_inflight = max_inflight
        self._max_queued = (max_queued if max_queued is not None
                            else Config.instance().push_manager_max_queued)
        self._lock = threading.Lock()
        self._inflight: set = set()      # (object_id, dest) being sent
        self._queue: "OrderedDict[Tuple[bytes, str], None]" = OrderedDict()
        self._active = 0
        # transfer workers spawn through the registry: they are named,
        # a hung sender surfaces in join_all() by name, and dead ones
        # are pruned on each spawn (raycheck RC09)
        self._threads = ThreadRegistry("push-manager")
        self.num_pushed = 0
        self.num_deduped = 0
        # overload plane: pushes shed because the outbound queue was at
        # its bound (a slow receiver must not grow the queue forever)
        self.num_shed = 0

    def join_all(self, timeout: float = 5.0) -> list:
        """Join outstanding transfer workers (teardown observability);
        returns the names still running."""
        return self._threads.join_all(timeout)

    def push(self, object_id: bytes, dest: str,
             downstream: Optional[list] = None) -> bool:
        """Schedule a push; returns False if it was already in flight
        (the dedup of PushManager::StartPush) or the bounded outbound
        queue shed it (the caller can re-request; broadcast's
        confirm-and-retry loop already does). ``downstream`` is a
        chunk-tree subtree plan ([[address, subtree], ...]) relayed to
        the send function — the receiver becomes an interior node and
        forwards onward (dedup stays keyed on (object, dest): a second
        request for the same pair rides the in-flight transfer)."""
        key = (object_id, dest)
        with self._lock:
            if key in self._inflight or key in self._queue:
                self.num_deduped += 1
                return False
            if len(self._queue) >= self._max_queued:
                self.num_shed += 1
                return False
            self._queue[key] = downstream
            self._pump_locked()
        return True

    def _pump_locked(self) -> None:
        while self._active < self._max_inflight and self._queue:
            key, downstream = self._queue.popitem(last=False)
            self._inflight.add(key)
            self._active += 1
            self._threads.spawn(
                self._run, f"push-{key[0].hex()[:8]}",
                args=(key, downstream))

    def _run(self, key: Tuple[bytes, str],
             downstream: Optional[list] = None) -> None:
        try:
            if downstream:
                self._send_fn(key[0], key[1], downstream)
            else:  # legacy two-arg send functions keep working
                self._send_fn(*key)
            with self._lock:  # worker threads race this counter
                self.num_pushed += 1
        except Exception as e:
            logger.info("push of %s to %s failed: %r",
                        key[0].hex()[:8], key[1], e)
        finally:
            with self._lock:
                self._inflight.discard(key)
                self._active -= 1
                self._pump_locked()

    def stats(self) -> dict:
        with self._lock:
            return {"inflight": len(self._inflight),
                    "queued": len(self._queue),
                    "num_pushed": self.num_pushed,
                    "num_deduped": self.num_deduped,
                    "num_shed": self.num_shed}
