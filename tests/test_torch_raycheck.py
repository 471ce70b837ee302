"""The port's raycheck against the JAX package's, on the CPU.

``ray_tpu_torch.tools.raycheck`` is the JAX package's checker with its
imports renamed. It is held to the reference on the same inputs:

1. **Corpus**: on every case of tests/raycheck_corpus/ each rule fires
   at exactly the ``# EXPECT`` lines, is quiet on the corrected code and
   honours inline suppressions, and the port's finding keys equal the
   JAX checker's. The rule table and its program/per-file split are the
   JAX package's.
2. **Live tree**: ``ray_tpu_torch/`` has zero unsuppressed findings
   with the port's own, empty, baseline. Either checker over either
   package gives the other's findings, and the same wire map.
3. **Wire map**: the port's GCS and raylet handlers are the sets
   tests/test_raycheck.py pins, each with a schema and a caller
   (``actor_list``'s is the dashboard head); the mutation schemas are
   pinned; mutations of copies of the port's files make
   RC06/RC07/RC12/RC13/RC14/RC15/RC16/RC17 fire.
4. **CLI**: ``python -m ray_tpu_torch.tools.raycheck`` exits 0 with
   "clean" on the repo; ``--json``, ``--sarif`` and
   ``--update-baseline`` round trip.
5. **Speed**: the port's scan of its tree costs at most 1.25 times the
   JAX checker's scan of the JAX package, both timed in this process one
   after the other, so the host's load bears on both alike.

The whole-tree scans run once each, in module-scoped fixtures.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.tools import raycheck as jax_raycheck
from ray_tpu.tools.raycheck import facts as jax_facts
from ray_tpu.tools.raycheck import rules as jax_rules
from ray_tpu_torch.tools import raycheck
from ray_tpu_torch.tools.raycheck import facts as raycheck_facts
from ray_tpu_torch.tools.raycheck import rules as raycheck_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "raycheck_corpus")
ALL_CODES = ["RC01", "RC02", "RC03", "RC04", "RC05",
             "RC06", "RC07", "RC08", "RC09", "RC10", "RC11",
             "RC12", "RC13", "RC14", "RC15", "RC16", "RC17"]
PKG = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
JAX_PKG = os.path.dirname(os.path.abspath(ray_tpu.__file__))
SPEED_RATIO = 1.25

BAD_FILE = "import time\n\n\ndef deadline(t):\n    return time.time() + t\n"


def _keys(findings):
    return [f.key for f in findings]


def _render(findings):
    return [f.render() for f in findings]


def _expected_lines(case_dir):
    """(relpath, lineno) of every ``# EXPECT``-marked corpus line."""
    expected = set()
    for path in raycheck.iter_py_files(case_dir):
        rel = os.path.relpath(path, case_dir).replace(os.sep, "/")
        with open(path) as f:
            for lineno, line in enumerate(f, start=1):
                if "# EXPECT" in line:
                    expected.add((rel, lineno))
    return expected


def _scan(checker, tree):
    """(findings, wall seconds, CPU seconds) of one whole-tree scan."""
    t0, c0 = time.monotonic(), time.process_time()
    findings = checker.check_tree(tree)
    return findings, time.monotonic() - t0, time.process_time() - c0


@pytest.fixture(scope="module")
def own_scans():
    """Each checker over its own package, one right after the other."""
    port = _scan(raycheck, PKG)
    jax = _scan(jax_raycheck, JAX_PKG)
    return {"port": port, "jax": jax}


@pytest.fixture(scope="module")
def jax_over_port():
    return jax_raycheck.check_tree(PKG)


@pytest.fixture(scope="module")
def port_over_jax():
    return raycheck.check_tree(JAX_PKG)


@pytest.fixture(scope="module")
def live_program():
    return raycheck_facts.Program(raycheck.load_tree(PKG), root=PKG)


# ---------------------------------------------------------------- corpus


@pytest.mark.parametrize("code", ALL_CODES)
def test_rule_fires_on_seeded_violations(code):
    case = os.path.join(CORPUS, f"{code.lower()}_fires")
    findings = raycheck.check_tree(case, rules=[code])
    assert {(f.path, f.line) for f in findings} == \
        _expected_lines(case), "\n".join(_render(findings))
    assert all(f.code == code for f in findings)
    assert all(len(f.message) > 40 for f in findings)
    jax = jax_raycheck.check_tree(case, rules=[code])
    assert _keys(findings) == _keys(jax)
    assert [f.message for f in findings] == [f.message for f in jax]


@pytest.mark.parametrize("code", ALL_CODES)
def test_rule_quiet_on_corrected_code(code):
    case = os.path.join(CORPUS, f"{code.lower()}_clean")
    findings = raycheck.check_tree(case, rules=[code])
    assert findings == [], "\n".join(_render(findings))
    assert jax_raycheck.check_tree(case, rules=[code]) == []


@pytest.mark.parametrize("code", ALL_CODES)
def test_rule_honors_inline_suppression(code):
    case = os.path.join(CORPUS, f"{code.lower()}_suppressed")
    findings = raycheck.check_tree(case, rules=[code])
    assert findings == [], "\n".join(_render(findings))
    assert jax_raycheck.check_tree(case, rules=[code]) == []


def test_whole_corpus_keys_equal_the_jax_checkers():
    """All rules at once over every case: the same keys and messages,
    so no rule fires on another rule's case in one checker alone."""
    port = raycheck.check_tree(CORPUS)
    jax = jax_raycheck.check_tree(CORPUS)
    assert port, "the corpus must give findings"
    assert _render(port) == _render(jax)


def test_unparseable_file_is_reported(tmp_path):
    bad = tmp_path / "cluster"
    bad.mkdir()
    (bad / "broken.py").write_text("def f(:\n")
    findings = raycheck.check_tree(str(tmp_path))
    assert [f.code for f in findings] == ["RC00"]
    assert _keys(findings) == _keys(jax_raycheck.check_tree(str(tmp_path)))


def test_rule_table_equals_the_jax_packages():
    port = [(r.code, r.title, r.program) for r in raycheck_rules.all_rules()]
    jax = [(r.code, r.title, r.program) for r in jax_rules.all_rules()]
    assert port == jax
    assert [code for code, _, _ in port] == ALL_CODES
    kinds = {code: program for code, _, program in port}
    assert all(not kinds[c] for c in ("RC01", "RC02", "RC03", "RC04",
                                      "RC05", "RC10", "RC11"))
    assert all(kinds[c] for c in ("RC06", "RC07", "RC08", "RC09",
                                  "RC12", "RC13", "RC14", "RC15",
                                  "RC16", "RC17"))


# -------------------------------------------------------------- live tree


def test_live_tree_has_zero_unsuppressed_findings(own_scans):
    findings = own_scans["port"][0]
    baseline = raycheck.load_baseline()
    fresh = [f for f in findings if f.key not in baseline]
    assert not fresh, (
        "the port regressed a raycheck invariant — fix it (preferred) "
        "or justify an inline suppression:\n" + "\n".join(_render(fresh)))


def test_shipped_baseline_is_empty_and_the_ports_own():
    assert raycheck.default_baseline_path().startswith(PKG + os.sep)
    assert raycheck.load_baseline() == set()


def test_checkers_agree_on_the_port(own_scans, jax_over_port):
    assert _render(own_scans["port"][0]) == _render(jax_over_port) == []


def test_checkers_agree_on_the_jax_package(own_scans, port_over_jax):
    assert _render(port_over_jax) == _render(own_scans["jax"][0]) == []


def test_port_scan_costs_at_most_the_jax_scans_ratio(own_scans):
    """Relative, not an absolute bound: both scans ran in this process
    one after the other, and their CPU seconds (this process's alone) are
    compared, so neither a slow host nor other processes' load moves the
    ratio much."""
    _, port_wall, port_cpu = own_scans["port"]
    _, jax_wall, jax_cpu = own_scans["jax"]
    assert port_cpu <= SPEED_RATIO * jax_cpu, (
        f"port {port_cpu:.2f} s CPU ({port_wall:.2f} s wall) against "
        f"JAX {jax_cpu:.2f} s CPU ({jax_wall:.2f} s wall)")


# ------------------------------------------------------------- wire map

GCS_HANDLERS = {
    "register_node", "heartbeat", "cluster_view", "drain_node",
    "kv_put", "kv_get", "kv_del", "kv_keys",
    "object_add_location", "object_add_locations",
    "object_remove_location", "object_locations",
    "object_wait_location",
    "actor_create", "actor_get", "actor_by_name", "actor_kill",
    "actor_list", "report_actor_failure",
    "actor_create_batch", "actor_kill_batch", "actor_wait",
    "pg_create", "pg_get", "pg_remove", "pg_pending",
    "job_view", "ping",
    "pubsub_subscribe", "pubsub_unsubscribe", "pubsub_publish",
    "pubsub_poll",
    "collect_timeline",
}

RAYLET_HANDLERS = {
    "submit_task", "submit_task_batch", "wait_task", "task_state",
    "put_object", "wait_object", "free_objects",
    "get_object_info", "get_object",
    "push_object", "push_offer", "push_begin", "push_chunk",
    "push_end", "push_abort", "pull_object",
    "create_actor", "actor_call", "kill_actor", "kill_actor_batch",
    "prepare_bundle", "commit_bundle", "return_bundle",
    "node_stats", "ping", "perf_dump", "preempt_notice",
}


def _handlers(program):
    by_server = {}
    for h in program.handlers:
        by_server.setdefault(h.server, set()).add(h.method)
    return by_server


def test_wire_map_handlers_pinned(live_program):
    by_server = _handlers(live_program)
    assert by_server["gcs_server.GcsService"] == GCS_HANDLERS
    assert by_server["raylet_server.RayletServer"] == RAYLET_HANDLERS


def test_wire_map_every_handler_has_schema_and_caller(live_program):
    schemas = live_program.schema_map()
    called = live_program.called_methods()
    for method in sorted(GCS_HANDLERS | RAYLET_HANDLERS):
        assert method in schemas, f"{method} lost its @message schema"
        assert method in called, f"{method} lost its last caller"
    callers = {c.path for c in live_program.call_sites
               if c.method == "actor_list"}
    assert "observability/dashboard_head.py" in callers, callers


def test_wire_map_equals_the_jax_checkers(live_program):
    """The JAX checker extracts the same wire map from the port."""
    jax = jax_facts.Program(jax_raycheck.load_tree(PKG), root=PKG)
    assert _handlers(jax) == _handlers(live_program)
    assert jax.called_methods() == live_program.called_methods()
    assert set(jax.schema_map()) == set(live_program.schema_map())


def test_wire_map_mutation_schemas_pinned(live_program):
    schemas = live_program.schema_map()
    expected = {
        "actor_create": ({"actor_id", "cls_bytes", "args_bytes",
                          "resources"},
                         {"max_restarts", "name", "owner", "token"}),
        "actor_kill": ({"actor_id"}, {"no_restart", "token"}),
        "report_actor_failure": ({"actor_id"}, {"token"}),
        "pg_create": ({"pg_id", "bundles"}, {"strategy", "token"}),
        "pg_remove": ({"pg_id"}, {"token"}),
    }
    for method, (required, optional) in expected.items():
        sd = schemas[method]
        assert {f.name for f in sd.fields if f.required} == required, \
            f"{method} required fields drifted"
        assert {f.name for f in sd.fields if not f.required} == optional, \
            f"{method} optional fields drifted"


def _copy_port(dst, subdirs=("cluster",), mutate=None, only=None):
    """Copy the port's top-level modules of ``subdirs`` (or just the
    file names in ``only``) into ``dst``, a fresh scan root; ``mutate``
    is (relpath, old, new), one textual change to one file."""
    for sub in subdirs:
        (dst / sub).mkdir(parents=True)
        src = os.path.join(PKG, sub)
        for name in sorted(os.listdir(src)):
            if not name.endswith(".py") or only and name not in only:
                continue
            with open(os.path.join(src, name)) as f:
                text = f.read()
            if mutate is not None and mutate[0] == f"{sub}/{name}":
                assert mutate[1] in text, \
                    f"mutation anchor {mutate[1]!r} not in {sub}/{name}"
                text = text.replace(mutate[1], mutate[2])
            (dst / sub / name).write_text(text)
    return str(dst)


def _fresh_findings(tmp_path, mutate, rules, subdirs=("cluster",),
                    only=None):
    """Findings the mutation INTRODUCED (subset-scan artifacts cancel
    out against the unmutated copy of the same subset)."""
    base = raycheck.check_tree(
        _copy_port(tmp_path / "base", subdirs, only=only), rules=rules)
    mutated = raycheck.check_tree(
        _copy_port(tmp_path / "mut", subdirs, mutate, only), rules=rules)
    base_keys = {(f.code, f.path, f.message) for f in base}
    fresh = [f for f in mutated
             if (f.code, f.path, f.message) not in base_keys]
    assert fresh, "the mutation introduced no finding"
    return fresh, "\n".join(_render(fresh))


def test_renamed_gcs_handler_fires_rc06(tmp_path):
    fresh, messages = _fresh_findings(
        tmp_path, ("cluster/gcs_server.py",
                   '"actor_create", "actor_get"',
                   '"actor_createx", "actor_get"'), rules=["RC06"])
    assert any(f.code == "RC06" and "'actor_create'" in f.message
               and "no registered handler" in f.message
               for f in fresh), messages
    assert any(f.code == "RC06" and "actor_createx" in f.message
               for f in fresh), messages


def test_dropped_dashboard_head_orphans_actor_list(tmp_path):
    """The head is ``actor_list``'s one caller: without it the handler
    is dead wire surface again."""
    _copy_port(tmp_path, ("cluster", "observability"))
    assert not [f for f in raycheck.check_tree(str(tmp_path),
                                               rules=["RC06"])
                if "actor_list" in f.message]
    os.unlink(tmp_path / "observability" / "dashboard_head.py")
    findings = raycheck.check_tree(str(tmp_path), rules=["RC06"])
    assert any(f.path == "cluster/gcs_server.py"
               and "'actor_list'" in f.message for f in findings), \
        "\n".join(_render(findings))


def test_mutated_schema_field_fires_rc07(tmp_path):
    fresh, messages = _fresh_findings(
        tmp_path, ("cluster/schema.py", "    cls_bytes: bytes",
                   "    cls_blob: bytes"), rules=["RC07"])
    assert any(f.code == "RC07" and "cls_blob" in f.message
               for f in fresh), messages
    assert any(f.code == "RC07" and "cls_bytes" in f.message
               for f in fresh), messages


def test_dropped_release_fires_rc12(tmp_path):
    """The port's worker maps its store segment under a justified
    suppression; without the justification the held resource fires."""
    fresh, messages = _fresh_findings(
        tmp_path, ("cluster/worker_main.py",
                   "            # raycheck: disable=RC12 — "
                   "process-lifetime segment mapping; exit reclaims\n",
                   ""), rules=["RC12"], only=("worker_main.py",))
    assert all(f.code == "RC12" and f.path == "cluster/worker_main.py"
               for f in fresh), messages


def test_illegal_transition_fires_rc13(tmp_path):
    src = os.path.join(PKG, "tools", "raycheck", "protocols.py")
    with open(src) as f:
        text = f.read()
    sub = tmp_path / "cluster"
    sub.mkdir()
    (sub / "protocols.py").write_text(text)
    assert raycheck.check_tree(str(tmp_path), rules=["RC13"]) == []
    anchor = '        T("RECEIVING", "SEALED", "push_end"),\n'
    assert anchor in text
    (sub / "protocols.py").write_text(text.replace(
        anchor, anchor + '        T("SEALED", "RECEIVING", "push_begin"),\n'))
    findings = raycheck.check_tree(str(tmp_path), rules=["RC13"])
    assert any("illegal transition out of terminal" in f.message
               and f.code == "RC13" for f in findings), \
        "\n".join(_render(findings))


def test_unsuppressed_collective_knob_fires_rc14(tmp_path):
    """``collective_op_timeout_s`` waits for the collective port under a
    stated suppression; dropping it brings back the finding."""
    fresh, messages = _fresh_findings(
        tmp_path, ("_private/config.py",
                   "    # raycheck: disable=RC14 — read by "
                   "collective/api.py, not ported yet (ROADMAP items "
                   "5–8, the four-card items)\n", ""),
        rules=["RC14"], subdirs=("cluster", "_private"))
    assert [(f.code, f.path) for f in fresh] == \
        [("RC14", "_private/config.py")], messages
    assert "collective_op_timeout_s" in fresh[0].message
    assert "never read" in fresh[0].message


def test_orphaned_counter_fires_rc15(tmp_path):
    fresh, messages = _fresh_findings(
        tmp_path, ("cluster/integrity.py",
                   "        corrupt_replicas_discarded.inc()",
                   "        corrupt_replicas_discardd.inc()"),
        rules=["RC15"], subdirs=("cluster", "observability"))
    assert any(f.path == "cluster/integrity.py"
               and "corrupt_replicas_discardd" in f.message
               for f in fresh), messages


def test_deleted_lock_acquire_fires_rc16(tmp_path):
    fresh, messages = _fresh_findings(
        tmp_path, ("cluster/raylet_server.py",
                   "        with self._stats_lock:\n"
                   "            self.num_stream_fetches += 1",
                   "        self.num_stream_fetches += 1"),
        rules=["RC16"])
    assert any(f.code == "RC16" and "num_stream_fetches" in f.message
               for f in fresh), messages


def test_dropped_join_timeout_fires_rc17(tmp_path):
    fresh, messages = _fresh_findings(
        tmp_path, ("cluster/gcs_server.py",
                   "            w.join(max(0.0, deadline - "
                   "time.monotonic()))",
                   "            w.join()"), rules=["RC17"])
    assert any(f.code == "RC17" and ".join()" in f.message
               for f in fresh), messages


def test_thread_root_naming_shared_between_checker_and_runtime():
    """The label the port's raycheck derives for a spawn target equals
    the one the port's ThreadRegistry records for the same function."""
    import threading

    from ray_tpu_torch.cluster.raylet_server import RayletServer
    from ray_tpu_torch.cluster.threads import ThreadRegistry, root_label

    static = raycheck_facts._root_label(
        "cluster/raylet_server.py::RayletServer._heartbeat_loop")
    assert static == "raylet_server.RayletServer._heartbeat_loop"
    assert static == root_label(RayletServer._heartbeat_loop)
    assert static == jax_facts._root_label(
        "cluster/raylet_server.py::RayletServer._heartbeat_loop")

    reg = ThreadRegistry("test")
    done = threading.Event()
    t = reg.spawn(lambda: done.wait(10.0), "test-worker")
    try:
        roots = reg.roots()
        assert roots["test-worker"].startswith("test_torch_raycheck.")
    finally:
        done.set()
        t.join(timeout=10.0)


def test_static_thread_roots_are_labelled_as_the_runtime_labels(
        live_program):
    """Every thread root the checker finds in the port carries the
    label ``_root_label`` derives from its function id, the naming
    ``root_label`` gives a live thread."""
    labels = {r.label for r in live_program.thread_roots}
    assert "raylet_server.RayletServer._heartbeat_loop" in labels
    assert all(r.label == raycheck_facts._root_label(r.fid)
               for r in live_program.thread_roots)


# -------------------------------------------------------------------- CLI


def _cli(*args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.raycheck", *args],
        capture_output=True, text=True, timeout=300, cwd=cwd or ROOT)


def _bad_tree(tmp_path):
    sub = tmp_path / "cluster"
    sub.mkdir()
    (sub / "bad.py").write_text(BAD_FILE)
    return str(tmp_path)


def test_cli_exits_zero_on_repo():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def test_cli_reports_violations(tmp_path):
    proc = _cli(_bad_tree(tmp_path))
    assert proc.returncode == 1
    assert "RC02" in proc.stdout


def test_cli_json_report(tmp_path):
    proc = _cli("--json", _bad_tree(tmp_path))
    assert proc.returncode == 1
    report = json.loads(proc.stdout)
    assert report["count"] == len(report["findings"]) >= 1
    assert not report["clean"]
    f = report["findings"][0]
    assert f["code"] == "RC02"
    assert f["path"] == "cluster/bad.py"
    assert f["key"] == f"{f['path']}:{f['line']}:{f['code']}"


def test_cli_sarif_roundtrip(tmp_path):
    out = tmp_path / "report.sarif"
    proc = _cli("--sarif", str(out), _bad_tree(tmp_path))
    assert proc.returncode == 1
    with open(out) as f:
        doc = json.load(f)
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-2.1.0.json")
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "raycheck"
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == \
        set(ALL_CODES) | {"RC00"}
    r = run["results"][0]
    assert r["ruleId"] == "RC02"
    loc = r["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "cluster/bad.py"
    key = r["partialFingerprints"]["raycheckKey"]
    assert key == f"cluster/bad.py:{loc['region']['startLine']}:RC02"


def test_cli_update_baseline_then_clean(tmp_path):
    tree = _bad_tree(tmp_path)
    bl = tmp_path / "baseline.txt"
    proc = _cli("--baseline", str(bl), "--update-baseline", tree)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert bl.exists()
    proc = _cli("--baseline", str(bl), tree)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "baselined" in proc.stdout
