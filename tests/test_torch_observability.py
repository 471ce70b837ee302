"""The port's observability plane on the CPU: structured events and the
profiler's Chrome-trace timeline (observability/{events,profiling}.py),
held against the JAX package's copies and tests/test_observability.py.

Parity is exact: the same ``emit`` sequence gives the same event dicts
in both packages, leaving out ``timestamp`` and ``pid`` (the clock and
the process), and a profiler ring of the same capacity keeps and drops
the same spans.
"""

import json

import ray_tpu_torch
from ray_tpu.observability import events as jax_events
from ray_tpu.observability.profiling import Profiler as JaxProfiler
from ray_tpu_torch._private.config import Config
from ray_tpu_torch.observability import (
    EventLog,
    Profiler,
    Severity,
    emit,
    global_profiler,
    profile,
    timeline,
)

EMITS = [
    ("node_added", "node n1 joined", "INFO", {"node_id": "n1"}),
    ("actor_died", "actor a7 died", "ERROR", {"actor_id": "a7", "exit": 1}),
    ("spill", "spilled 3 objects", "DEBUG", {"count": 3}),
    ("node_added", "node n2 joined", "INFO", {"node_id": "n2"}),
    ("overload", "shedding", "WARNING", {"queue": 512}),
]


def _run_emits(log, severity_cls):
    for label, message, severity, fields in EMITS:
        log.emit(label, message, severity_cls(severity), **fields)


def _stable(events):
    return [{k: v for k, v in e.items() if k not in ("timestamp", "pid")}
            for e in events]


def test_emit_sequence_equals_reference(tmp_path):
    ours = EventLog(file_path=str(tmp_path / "ours.jsonl"))
    ref = jax_events.EventLog(file_path=str(tmp_path / "ref.jsonl"))
    _run_emits(ours, Severity)
    _run_emits(ref, jax_events.Severity)
    assert _stable(ours.list()) == _stable(ref.list())
    assert len(ours.list()) == len(EMITS)
    for label, floor in (("node_added", None), (None, Severity.WARNING)):
        ref_floor = None if floor is None else jax_events.Severity(floor)
        assert _stable(ours.list(label, floor)) == \
            _stable(ref.list(label, ref_floor))
    on_disk = [json.loads(line) for line in open(tmp_path / "ours.jsonl")]
    ref_disk = [json.loads(line) for line in open(tmp_path / "ref.jsonl")]
    assert _stable(on_disk) == _stable(ref_disk) == _stable(ours.list())
    ours.clear()
    assert ours.list() == []


def test_fatal_event_reaches_flight_recorder(tmp_path, monkeypatch):
    """A FATAL event dumps the port's flight recorder (events.emit →
    flight_recorder.record_fatal) while the process can still write."""
    from ray_tpu_torch.observability.flight_recorder import global_recorder

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    global_recorder.record_span({"name": "led_up_to_it",
                                 "start_time": 1.0, "end_time": 2.0})
    emit("crash", "irrecoverable store corruption", Severity.FATAL,
         node_id="n1")
    dumps = list(tmp_path.glob("ray_tpu_flight_*.jsonl"))
    assert dumps, "FATAL event produced no dump"
    lines = [json.loads(line) for line in open(dumps[0])]
    assert lines[0]["reason"] == "fatal_event"
    assert any(line.get("kind") == "event"
               and line.get("message") == "irrecoverable store corruption"
               for line in lines)
    assert any(line.get("name") == "led_up_to_it" for line in lines)


def test_profiler_ring_drops_as_reference():
    ours, ref = Profiler(max_events=4), JaxProfiler(max_events=4)
    for p in (ours, ref):
        for i in range(10):
            with p.profile(f"e{i}", {"i": i}):
                pass
        p.add_instant("marker")
    assert ours.dropped == ref.dropped == 7
    keys = ("name", "cat", "ph", "args")
    assert [{k: e[k] for k in keys} for e in ours.events()] == \
        [{k: e[k] for k in keys} for e in ref.events()]
    assert [e["name"] for e in ours.events()] == ["e7", "e8", "e9",
                                                  "marker"]
    ours.clear()
    assert ours.events() == [] and ours.dropped == 0


def test_timeline_disabled_gives_empty_trace():
    cfg = Config.instance()
    saved = cfg.enable_timeline
    global_profiler.clear()
    cfg.enable_timeline = False
    try:
        with profile("task:execute"):
            pass
        global_profiler.add_instant("marker")
        assert timeline() == []
    finally:
        cfg.enable_timeline = saved
        global_profiler.clear()


def test_timeline_writes_chrome_trace(tmp_path):
    global_profiler.clear()
    try:
        with profile("b1_batch", {"n": 3}):
            pass
        global_profiler.add_instant("marker")
        path = ray_tpu_torch.timeline(str(tmp_path / "trace.json"))
        trace = json.load(open(path))
        from ray_tpu_torch.gcs import timeline as gcs_timeline

        assert gcs_timeline() == trace
    finally:
        global_profiler.clear()
    assert [e["name"] for e in trace] == ["b1_batch", "marker"]
    span, instant = trace
    assert span["ph"] == "X" and span["dur"] >= 0
    assert span["args"] == {"n": 3}
    assert instant["ph"] == "i"
    for event in trace:
        assert {"name", "cat", "ph", "ts", "pid", "tid",
                "args"} <= set(event)
