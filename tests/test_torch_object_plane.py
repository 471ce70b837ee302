"""The port's pubsub and byte store on the CPU: a subset of
tests/test_pubsub.py and tests/test_byte_store.py.

The publisher and subscriber contracts, the GCS-hosted node, actor and
log channels on a live ``ProcessCluster``, the byte store's capacity,
spill and shm tiers, the push manager, the sweep of dead owners'
segments, and the same-host zero-copy read of a peer raylet's object.
"""

import os
import subprocess
import sys
import tempfile
import threading
import time

import cloudpickle
import numpy as np
import pytest

from ray_tpu_torch.cluster.byte_store import (
    ByteStore,
    PushManager,
    sweep_stale_segments,
)
from ray_tpu_torch.pubsub import (
    ACTOR_CHANNEL,
    LOG_CHANNEL,
    NODE_CHANNEL,
    Publisher,
    Subscriber,
)

cloudpickle.register_pickle_by_value(sys.modules[__name__])

KB = 1024


def _wait_for(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


# ------------------------------------------------------------------ pubsub


def test_publish_to_key_subscriber():
    pub = Publisher()
    pub.subscribe("s1", "CH", "k1")
    assert pub.publish("CH", "k1", {"v": 1}) == 1
    assert pub.publish("CH", "other", {"v": 2}) == 0
    reply = pub.poll("s1", timeout=0)
    assert reply["messages"] == [("CH", "k1", {"v": 1})]
    assert reply["dropped"] == 0


def test_all_keys_and_multiple_subscribers():
    pub = Publisher()
    pub.subscribe("s1", "CH", None)
    pub.subscribe("s2", "CH", "a")
    assert pub.publish("CH", "a", 1) == 2
    assert pub.publish("CH", "b", 2) == 1
    msgs = pub.poll("s1", timeout=0)["messages"]
    assert [(k, m) for _, k, m in msgs] == [("a", 1), ("b", 2)]
    assert pub.poll("s2", timeout=0)["messages"] == [("CH", "a", 1)]


def test_unsubscribe_key_and_entirely():
    pub = Publisher()
    pub.subscribe("s1", "CH", "k")
    pub.unsubscribe("s1", "CH", "k")
    assert pub.publish("CH", "k", 1) == 0
    pub.subscribe("s1", "CH", "k")
    pub.unsubscribe("s1")
    assert pub.poll("s1", timeout=0).get("unsubscribed") is True


def test_mailbox_bounded_drops_oldest():
    pub = Publisher(mailbox_maxlen=3)
    pub.subscribe("s1", "CH", None)
    for i in range(5):
        pub.publish("CH", "k", i)
    reply = pub.poll("s1", timeout=0)
    assert [m for _, _, m in reply["messages"]] == [2, 3, 4]
    assert reply["dropped"] == 2


def test_long_poll_blocks_until_publish():
    pub = Publisher()
    pub.subscribe("s1", "CH", None)
    got = {}
    t = threading.Thread(target=lambda: got.update(pub.poll("s1", 5.0)))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()
    pub.publish("CH", "k", "wake")
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["messages"] == [("CH", "k", "wake")]


def test_gc_dead_subscribers():
    pub = Publisher(subscriber_timeout_s=0.05)
    pub.subscribe("s1", "CH", None)
    pub.subscribe("s2", "CH", None)
    pub.poll("s2", timeout=0)
    time.sleep(0.1)
    pub.poll("s2", timeout=0)
    assert pub.gc_dead_subscribers() == ["s1"]
    assert pub.stats()["num_subscribers"] == 1


def test_subscriber_callbacks_survive_errors_and_publisher_drop():
    pub = Publisher()
    sub = Subscriber("s1", publisher=pub, poll_timeout_s=0.1)
    seen = []

    def bad(channel, key, message):
        raise RuntimeError("boom")

    sub.subscribe("BAD", None, bad)
    sub.subscribe("CH", "k1", lambda c, k, m: seen.append(m))
    pub.publish("BAD", "k", 0)
    pub.publish("CH", "k1", "before")
    pub.publish("CH", "k2", "filtered-out")
    assert _wait_for(lambda: "before" in seen, 5)
    pub.unsubscribe("s1")  # what gc_dead_subscribers does
    time.sleep(0.3)
    pub.publish("CH", "k1", "after")
    assert _wait_for(lambda: "after" in seen, 5)
    assert "filtered-out" not in seen
    sub.close()


@pytest.fixture(scope="module")
def proc_cluster():
    from ray_tpu_torch.cluster.process_cluster import (
        ClusterClient,
        ProcessCluster,
    )

    cluster = ProcessCluster(heartbeat_period_ms=50,
                             num_heartbeats_timeout=10, gcs_device="cpu")
    try:
        producer = cluster.add_node(num_cpus=2,
                                    object_store_memory=32 << 20)
        consumer = cluster.add_node(num_cpus=2,
                                    object_store_memory=32 << 20)
        cluster.wait_for_nodes(2)
        client = ClusterClient(cluster.gcs_address)
    except BaseException:
        cluster.shutdown()
        raise
    yield cluster, client, producer, consumer
    client.close()
    cluster.shutdown()


class _Chatty:
    def speak(self):
        print("hello-from-worker", file=sys.stderr, flush=True)
        return "spoke"


def test_gcs_node_channel(proc_cluster):
    cluster, client, producer, consumer = proc_cluster
    sub = client.subscriber(poll_timeout_s=0.5)
    events = []
    sub.subscribe(NODE_CHANNEL, None,
                  lambda c, k, m: events.append((k, m)))
    extra = cluster.add_node(num_cpus=1, object_store_memory=16 << 20)
    assert _wait_for(lambda: any(
        k == extra and m.get("alive") for k, m in events))
    cluster.kill_node(extra)
    assert _wait_for(lambda: any(
        k == extra and m.get("alive") is False for k, m in events))
    sub.close()


def test_gcs_actor_and_log_channels(proc_cluster):
    cluster, client, producer, consumer = proc_cluster
    sub = client.subscriber(poll_timeout_s=0.5)
    states, lines = [], []
    sub.subscribe(ACTOR_CHANNEL, None,
                  lambda c, k, m: states.append((k, m["state"])))
    sub.subscribe(LOG_CHANNEL, None,
                  lambda c, k, m: lines.extend(
                      e["line"] for e in m["batch"]))
    handle = client.create_actor(_Chatty)
    assert handle.speak() == "spoke"
    aid = handle.actor_id
    assert _wait_for(lambda: (aid, "ALIVE") in states)
    assert _wait_for(lambda: any("hello-from-worker" in ln
                                 for ln in lines))
    client.kill_actor(handle)
    assert _wait_for(lambda: (aid, "DEAD") in states)
    sub.close()


def test_consumer_reads_peer_object_without_replica(proc_cluster):
    """Same-host consumption: the consumer raylet pins the object in the
    producer's segment and its worker reads the pages in place."""
    cluster, client, producer, consumer = proc_cluster
    before = cluster.node_stats(consumer)["fetches"]["zero_copy"]
    ref = client.submit(lambda: np.arange(1024 * 1024, dtype=np.int32),
                        node_id=producer)
    client.get(ref)
    out = client.submit(lambda a: int(a.sum()), (ref,), node_id=consumer)
    n = 1024 * 1024
    assert client.get(out, timeout=60.0) == n * (n - 1) // 2
    stats = cluster.node_stats(consumer)
    assert stats["fetches"]["zero_copy"] == before + 1
    assert stats["store"]["tiers"]["shm"] == 0


# -------------------------------------------------------------- byte store


def make_store(capacity=64 * KB, **kw):
    kw.setdefault("use_shm", False)  # the deterministic heap tier
    return ByteStore(capacity=capacity, **kw)


def test_replicas_dropped_before_primaries(tmp_path):
    dropped = []
    s = make_store(capacity=10 * KB, spill_dir=str(tmp_path),
                   on_replica_dropped=dropped.append)
    s.put(b"P" * 28, b"p" * (4 * KB), primary=True)
    s.put(b"R" * 28, b"r" * (4 * KB), primary=False)
    s.put(b"N" * 28, b"n" * (4 * KB), primary=True)
    assert dropped == [b"R" * 28]
    assert not s.contains(b"R" * 28)
    assert s.info(b"P" * 28)["where"] == "mem"
    assert s.total_bytes <= s.capacity


def test_primaries_spill_lru_first_and_restore(tmp_path):
    s = make_store(capacity=10 * KB, spill_dir=str(tmp_path))
    s.put(b"1" * 28, b"a" * (4 * KB))
    s.put(b"2" * 28, b"b" * (4 * KB))
    s.get(b"1" * 28)  # object 2 is now the coldest
    s.put(b"3" * 28, b"c" * (4 * KB))
    assert s.info(b"2" * 28)["where"] == "disk"
    assert s.info(b"1" * 28)["where"] == "mem"
    assert s.get(b"2" * 28) == (False, b"b" * (4 * KB))
    assert s.num_restored == 1
    assert s.total_bytes <= s.capacity


def test_oversized_object_and_error_flag_go_through_disk(tmp_path):
    s = make_store(capacity=8 * KB, spill_dir=str(tmp_path))
    big = b"z" * (32 * KB)
    assert s.put(b"B" * 28, big)
    assert s.info(b"B" * 28)["where"] == "disk"
    assert s.get(b"B" * 28) == (False, big)
    s.put(b"E" * 28, b"e" * (2 * KB), is_error=True)
    s.put(b"F" * 28, b"f" * (8 * KB))  # spills E
    assert s.info(b"E" * 28)["where"] == "disk"
    assert s.get(b"E" * 28) == (True, b"e" * (2 * KB))


def test_many_puts_never_exceed_capacity(tmp_path):
    s = make_store(capacity=16 * KB, spill_dir=str(tmp_path))
    for i in range(64):
        s.put(bytes([i]) * 28, bytes([i]) * KB)
        assert s.total_bytes <= s.capacity
    for i in range(64):
        assert s.get(bytes([i]) * 28)[1] == bytes([i]) * KB


def test_large_objects_land_in_shm_with_their_trailer():
    from ray_tpu_torch.cluster import integrity
    from ray_tpu_torch.cluster.byte_store import attach_shm, shm_key

    s = ByteStore(capacity=4 * 1024 * KB, shm_min_bytes=KB)
    try:
        oid = b"S" * 28
        payload = b"q" * (256 * KB)
        s.put(oid, payload)
        assert s.info(oid)["where"] == "shm"
        assert s.get(oid) == (False, payload)
        seg = attach_shm(s.shm_path)
        raw = seg.get_bytes(shm_key(oid))
        body, crc = integrity.split_shm(raw, len(payload))
        assert bytes(body) == payload
        assert crc == integrity.checksum(payload)
    finally:
        s.close()


def test_push_manager_dedup_throttle_and_failures():
    started = []
    release = threading.Event()

    def send(oid, dest):
        started.append((oid, dest))
        release.wait(5.0)

    pm = PushManager(send, max_inflight=2)
    assert pm.push(b"a", "n1")
    assert not pm.push(b"a", "n1")  # dedup while in flight
    assert pm.push(b"a", "n2")
    assert pm.push(b"b", "n1")      # queued behind the cap
    time.sleep(0.2)
    assert len(started) == 2
    release.set()
    assert _wait_for(lambda: pm.num_pushed == 3, 5)
    assert pm.push(b"a", "n1")

    def failing(oid, dest):
        raise RuntimeError("peer gone")

    pm2 = PushManager(failing, max_inflight=1)
    for i in range(4):
        pm2.push(bytes([i]), "n1")
    assert _wait_for(lambda: pm2.stats()["inflight"] == 0, 5)
    assert pm2.stats()["queued"] == 0


def test_sweep_reclaims_dead_owner_segments_of_this_package_only():
    """A dead owner's ``ray_tpu_torch_store_`` segment goes; a live
    owner's stays, and the JAX package's segments are left to its own
    sweep."""
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    dead, live = p.pid, os.getpid()
    shm_dir = ("/dev/shm" if os.path.isdir("/dev/shm")
               else tempfile.gettempdir())
    stale = os.path.join(shm_dir, f"ray_tpu_torch_store_{dead}_deadbeef")
    mine = os.path.join(shm_dir, f"ray_tpu_torch_store_{live}_cafef00d")
    other = os.path.join(shm_dir, f"ray_tpu_store_{dead}_deadbeef")
    for f in (stale, mine, other):
        with open(f, "wb") as fh:
            fh.write(b"x")
    try:
        sweep_stale_segments(min_age_s=0.0)
        assert not os.path.exists(stale)
        assert os.path.exists(mine)
        assert os.path.exists(other)
    finally:
        for f in (stale, mine, other):
            if os.path.exists(f):
                os.unlink(f)
