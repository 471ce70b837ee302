"""The port's object-store integrity plane on the CPU
(core/object_store.py through cluster/integrity.py), held against the
JAX package's store and tests/test_integrity.py's MemoryStore cases.

- Spill files carry ``integrity.pack_spill_header`` (magic, flags, crc32
  of the pickled payload): for the same value the port writes the
  reference's bytes exactly.
- A flipped byte in a spill file makes the restore raise
  ``ObjectCorruptedError``; the copy is discarded and counted.
- ``integrity_verify_on_get`` checks a buffer value's put-time digest at
  get, so a buffer mutated after ``put`` raises.
- ``ray_tpu_objects_corruption_detected{seam}`` and the discarded-replica
  counter move in the port exactly as in the reference for the same
  scenarios.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu._private.config import Config as JaxConfig
from ray_tpu._private.ids import ObjectID as JaxObjectID
from ray_tpu.core.object_store import MemoryStore as JaxMemoryStore
from ray_tpu.exceptions import ObjectCorruptedError as JaxCorrupted
from ray_tpu.observability import metrics as jax_metrics
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.cluster import integrity
from ray_tpu_torch.core.object_store import MemoryStore
from ray_tpu_torch.exceptions import ObjectCorruptedError
from ray_tpu_torch.observability import metrics

PORT = dict(store=MemoryStore, oid=ObjectID, corrupted=ObjectCorruptedError,
            metrics=metrics)
REF = dict(store=JaxMemoryStore, oid=JaxObjectID, corrupted=JaxCorrupted,
           metrics=jax_metrics)


@pytest.fixture(autouse=True)
def _integrity_on():
    saved = [(cfg, cfg.integrity_enabled, cfg.integrity_verify_on_get)
             for cfg in (Config.instance(), JaxConfig.instance())]
    for cfg, _, _ in saved:
        cfg.integrity_enabled = True
        cfg.integrity_verify_on_get = False
    try:
        yield
    finally:
        for cfg, on, on_get in saved:
            cfg.integrity_enabled = on
            cfg.integrity_verify_on_get = on_get


def _counts(metrics_mod):
    """{seam: detections} and the discarded-replica total."""
    detected = metrics_mod.get_metric("ray_tpu_objects_corruption_detected")
    discarded = metrics_mod.get_metric(
        "ray_tpu_corrupt_replicas_discarded")
    return ({key[0]: n for key, n in detected.series().items()},
            sum(discarded.series().values()))


def _moved(before, after):
    seams = {s: after[0][s] - before[0].get(s, 0) for s in after[0]}
    return ({s: n for s, n in seams.items() if n}, after[1] - before[1])


def _spilling_store(pkg, spill_dir, first, value):
    """A small store holding ``value`` under ``first``, spilled to disk
    by a second put past the threshold."""
    store = pkg["store"](capacity=100_000, spill_threshold=0.1,
                         spill_directory=str(spill_dir))
    oid = pkg["oid"](first * 28)
    store.put(oid, value)
    store.put(pkg["oid"](b"\x06" * 28), np.ones(20_000))
    path = os.path.join(str(spill_dir), f"{oid.hex()}.spill")
    assert store.stats()["num_spilled"] >= 1 and os.path.exists(path)
    return store, oid, path


def test_spill_file_bytes_equal_reference(tmp_path):
    value = np.arange(20_000, dtype=np.float64)
    files = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        store, oid, path = _spilling_store(pkg, tmp_path / name, b"\x05",
                                           value)
        files[name] = open(path, "rb").read()
        np.testing.assert_array_equal(store.get([oid])[0].value, value)
        assert not os.path.exists(path)  # restored: the file is gone
    size = integrity.SPILL_HEADER_SIZE
    assert files["port"][:size] == files["ref"][:size]
    assert files["port"][:4] == integrity.SPILL_MAGIC
    assert files["port"] == files["ref"]
    _, payload, crc = integrity.parse_spill(files["port"])
    assert crc == integrity.checksum(payload)


def test_spill_flip_raises_discards_and_counts_as_reference(tmp_path):
    moved = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        store, oid, path = _spilling_store(
            pkg, tmp_path / name, b"\x07",
            np.arange(20_000, dtype=np.float64))
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0x10  # middle of the array body
        open(path, "wb").write(bytes(raw))
        before = _counts(pkg["metrics"])
        with pytest.raises(pkg["corrupted"]) as err:
            store.get([oid], timeout=0.5)
        assert err.value.seam == "spill_restore"
        assert not store.contains(oid)  # dropped, not served
        assert not os.path.exists(path)
        assert store.stats()["num_corrupt_dropped"] == 1
        moved[name] = _moved(before, _counts(pkg["metrics"]))
    assert moved["port"] == moved["ref"] == ({"spill_restore": 1}, 1)


def test_verify_on_get_catches_mutation_as_reference():
    """A buffer value mutated after ``put`` fails its put-time digest at
    get, counted at the ``get`` seam, in both packages' stores."""
    moved = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        cfg = Config.instance() if pkg is PORT else JaxConfig.instance()
        cfg.integrity_verify_on_get = True
        store = pkg["store"](capacity=1 << 20)
        clean, mutated = pkg["oid"](b"\x03" * 28), pkg["oid"](b"\x04" * 28)
        store.put(clean, b"n" * 4096)
        assert store.get([clean])[0].value == b"n" * 4096
        value = bytearray(b"m" * 4096)
        store.put(mutated, value)
        value[100] = 0x00  # mutate the shared buffer after put
        before = _counts(pkg["metrics"])
        with pytest.raises(pkg["corrupted"]) as err:
            store.get([mutated])
        assert err.value.seam == "get"
        moved[name] = _moved(before, _counts(pkg["metrics"]))
    assert moved["port"] == moved["ref"] == ({"get": 1}, 1)


def test_verify_on_get_through_the_runtime():
    Config.instance().integrity_verify_on_get = True
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        assert ray_tpu_torch.get(ray_tpu_torch.put(b"n" * 4096)) == \
            b"n" * 4096
        value = bytearray(b"m" * 4096)
        ref = ray_tpu_torch.put(value)
        value[100] = 0x00
        with pytest.raises(ObjectCorruptedError):
            ray_tpu_torch.get(ref)
    finally:
        ray_tpu_torch.shutdown()


def test_put_digest_only_under_verify_on_get():
    store = MemoryStore(capacity=1 << 20)
    plain, checked = ObjectID(b"\x01" * 28), ObjectID(b"\x02" * 28)
    store.put(plain, b"x" * 64)
    assert store.peek(plain).crc is None
    Config.instance().integrity_verify_on_get = True
    store.put(checked, b"x" * 64)
    assert store.peek(checked).crc == integrity.checksum(b"x" * 64)
