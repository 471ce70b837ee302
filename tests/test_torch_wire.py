"""The port's RPC wire, fault plane, trace sampler and integrity digests
on the CPU, held to the JAX package.

The server and schema cases of tests/test_wire_protocol.py run on the
port's ``RpcServer``/``RpcClient``. The fault plane and the head-based
trace sampler, given the same ``RAY_TPU_FAULT_PLAN`` seed in both
packages, must make the same decisions in the same order; integrity
digests of seeded byte strings must be equal.
"""

import json
import socket

import numpy as np
import pytest

from ray_tpu._private.config import Config as RefConfig
from ray_tpu.cluster import fault_plane as ref_fault
from ray_tpu.cluster import integrity as ref_integrity
from ray_tpu.util import tracing as ref_tracing
from ray_tpu_torch._private.config import Config as PortConfig
from ray_tpu_torch.cluster import fault_plane as port_fault
from ray_tpu_torch.cluster import integrity as port_integrity
from ray_tpu_torch.cluster import schema
from ray_tpu_torch.cluster.rpc import (
    PROTOCOL_MAGIC,
    PROTOCOL_VERSION,
    RpcClient,
    RpcServer,
    RpcVersionError,
)
from ray_tpu_torch.util import tracing as port_tracing


@pytest.fixture
def server():
    srv = RpcServer()
    srv.register("echo", lambda x: x, inline=True)
    srv.register("put_object",
                 lambda object_id, payload, is_error, register, primary:
                 {"is_error": is_error, "primary": primary},
                 inline=True)
    srv.start()
    yield srv
    srv.stop()


# ------------------------------------------------------------------ wire


def test_protocol_constants_match_reference():
    from ray_tpu.cluster import rpc as ref_rpc

    assert PROTOCOL_MAGIC == ref_rpc.PROTOCOL_MAGIC
    assert PROTOCOL_VERSION == ref_rpc.PROTOCOL_VERSION


def test_matching_versions_talk(server):
    client = RpcClient(server.address)
    try:
        assert client.call("echo", x=41, timeout=10.0) == 41
    finally:
        client.close()


def test_wrong_magic_is_refused(server):
    host, port = server.address.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=5.0)
    try:
        sock.sendall(b"HTTP1")  # not an rpc peer
        sock.settimeout(5.0)
        data = b""
        while True:
            got = sock.recv(4096)
            if not got:
                break
            data += got
        assert data[:4] == PROTOCOL_MAGIC  # its hello, then EOF
    finally:
        sock.close()


def test_version_skew_is_refused_at_connect(server):
    host, port = server.address.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=5.0)
    try:
        sock.sendall(PROTOCOL_MAGIC + bytes([PROTOCOL_VERSION + 1]))
        sock.settimeout(5.0)
        assert sock.recv(5) == PROTOCOL_MAGIC + bytes([PROTOCOL_VERSION])
        assert sock.recv(4096) == b""
    finally:
        sock.close()


def test_client_rejects_non_rpc_server():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    addr = f"127.0.0.1:{lsock.getsockname()[1]}"
    try:
        with pytest.raises(RpcVersionError):
            RpcClient(addr, connect_timeout=2.0)
    finally:
        lsock.close()


def test_unknown_field_dropped_for_rolling_upgrade(server):
    client = RpcClient(server.address)
    before = schema.validate.num_dropped
    try:
        out = client.call("put_object", object_id=b"x" * 28,
                          payload=b"p", compression="zstd", timeout=10.0)
        assert out == {"is_error": False, "primary": True}
    finally:
        client.close()
    assert schema.validate.num_dropped == before + 1


def test_wrong_type_rejected(server):
    client = RpcClient(server.address)
    try:
        with pytest.raises(schema.SchemaError):
            client.call("put_object", object_id="not-bytes", payload=b"p",
                        timeout=10.0)
    finally:
        client.close()


def test_schema_validation_matches_reference():
    from dataclasses import fields

    from ray_tpu.cluster import schema as ref_schema

    with pytest.raises(schema.SchemaError):
        schema.validate("put_object", {"payload": b"p"})
    assert schema.validate("echo", {"whatever": 1}) == {"whatever": 1}
    kwargs = {"object_id": b"i" * 28, "payload": b"p"}
    assert (schema.validate("put_object", dict(kwargs))
            == ref_schema.validate("put_object", dict(kwargs)))
    for method in ("push_begin", "push_chunk", "push_offer", "heartbeat",
                   "put_object", "submit_task"):
        port = [(f.name, f.default) for f in fields(
            schema.schema_for(method))]
        ref = [(f.name, f.default) for f in fields(
            ref_schema.schema_for(method))]
        assert port == ref, method


# ----------------------------------------------------- fault plane, sampler

PLAN = {"seed": 7, "rules": [
    {"direction": "request", "method": "push_*", "action": "delay",
     "prob": 0.4, "delay_ms": [1, 50]},
    {"direction": "request", "action": "drop", "prob": 0.1, "after": 3},
    {"direction": "reply", "dst": "127.0.0.1:7*", "action": "corrupt",
     "prob": 0.3},
    {"direction": "reply", "action": "duplicate", "prob": 0.2,
     "count": 25},
    {"direction": "connect", "action": "refuse", "prob": 0.05},
]}


def _events(seed, n):
    rng = np.random.default_rng(seed)
    dsts = [f"127.0.0.1:{p}" for p in (6379, 7001, 7002, 8000)]
    methods = ["push_chunk", "push_begin", "heartbeat", "submit_task",
               "actor_create_batch"]
    dirs = ["request", "reply", "connect"]
    return [(dirs[int(rng.integers(3))], dsts[int(rng.integers(4))],
             methods[int(rng.integers(5))]) for _ in range(n)]


@pytest.fixture
def seeded_plan(monkeypatch):
    """The same RAY_TPU_FAULT_PLAN in both packages, read afresh."""
    monkeypatch.setenv("RAY_TPU_FAULT_PLAN", json.dumps(PLAN))
    for mod in (ref_fault, port_fault):
        mod.clear_plane()
    yield
    monkeypatch.delenv("RAY_TPU_FAULT_PLAN")
    monkeypatch.delenv("RAY_TPU_tracing_sample_rate", raising=False)
    for mod in (ref_fault, port_fault):
        mod.clear_plane()
    for tr in (ref_tracing, port_tracing):
        tr.reset_sampling()
    RefConfig.reset()
    PortConfig.reset()


def test_fault_plane_decisions_match_reference(seeded_plan):
    ref_plane, port_plane = ref_fault.get_plane(), port_fault.get_plane()
    assert ref_plane is not None and port_plane is not None
    ref_out, port_out = [], []
    for direction, dst, method in _events(3, 2000):
        ref_out.append(ref_plane.decide(direction, dst, method))
        port_out.append(port_plane.decide(direction, dst, method))
    assert port_out == ref_out
    assert sum(d is not None for d in port_out) > 100
    assert port_plane.schedule() == ref_plane.schedule()
    for ns in ("rpc-backoff|127.0.0.1:6379", "tracing-sample"):
        a, b = ref_fault.derive_rng(ns), port_fault.derive_rng(ns)
        assert [a.random() for _ in range(100)] == \
            [b.random() for _ in range(100)]


def test_trace_sampler_replays_the_reference_decisions(seeded_plan,
                                                        monkeypatch):
    """At rate 0.3, 1,000 head-based sampling decisions from each
    package's sampler are the same sequence, and a reset replays it."""
    monkeypatch.setenv("RAY_TPU_tracing_sample_rate", "0.3")
    RefConfig.reset()
    PortConfig.reset()
    runs = []
    for _ in range(2):
        for tr in (ref_tracing, port_tracing):
            tr.reset_sampling()
        ref = [ref_tracing._sample() for _ in range(1000)]
        port = [port_tracing._sample() for _ in range(1000)]
        assert port == ref
        runs.append(port)
    assert runs[0] == runs[1]
    assert 200 < sum(runs[0]) < 400


# ------------------------------------------------------------- integrity


def test_integrity_digests_match_reference():
    assert port_integrity.CHECKSUM_IMPL == ref_integrity.CHECKSUM_IMPL
    assert port_integrity.TRAILER_SIZE == ref_integrity.TRAILER_SIZE
    rng = np.random.default_rng(11)
    for n in (0, 1, 7, 4096, 1 << 20):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        crc = port_integrity.checksum(data)
        assert crc == ref_integrity.checksum(data)
        assert port_integrity.checksum(memoryview(data)) == crc
        half = n // 2
        chained = port_integrity.checksum_update(
            port_integrity.checksum(data[:half]), data[half:])
        assert chained == ref_integrity.checksum_update(
            ref_integrity.checksum(data[:half]), data[half:])
        assert port_integrity.pack_trailer(crc) == \
            ref_integrity.pack_trailer(crc)
