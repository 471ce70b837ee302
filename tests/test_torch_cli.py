"""The port's command line, ``python -m ray_tpu_torch``, on the CPU.

``up`` and ``down`` with a YAML cluster config (the process provider,
its GCS on the CPU through ``gcs_device: "cpu"``), each in a process of
its own: the cluster outlives ``up``, and ``down`` reaps it from the
state file. On that cluster: ``status --address``, ``job submit
--wait``, ``job list``, ``job logs``, ``job status`` and ``job stop``.
Then ``microbenchmark --json`` after ``init(device="cpu")``: its rows
carry the JAX package's names, in its order. Every subprocess has a
time limit.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_client import _end_jax_leftovers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLUSTER_YAML = """
cluster_name: cli-up
provider:
  type: process
  gcs_device: cpu
  heartbeat_period_ms: 100
  num_heartbeats_timeout: 30
head_node_type: head
available_node_types:
  head:
    resources: {CPU: 2}
    min_workers: 0
    max_workers: 0
  worker:
    resources: {CPU: 2}
    min_workers: 1
    max_workers: 1
"""


def _cli(env, *argv, timeout=120):
    """Run the CLI -> (returncode, stdout, stderr). Its output goes to
    files: the servers ``up`` starts outlive it and hold its stderr."""
    import tempfile

    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", *argv], env=env,
            cwd=ROOT, stdout=out, stderr=err, timeout=timeout)
        out.seek(0)
        err.seek(0)
        return subprocess.CompletedProcess(proc.args, proc.returncode,
                                           out.read(), err.read())


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split()[2] != "Z"


@pytest.fixture(scope="module")
def cli_cluster(tmp_path_factory):
    """``up`` in a subprocess -> (env, gcs address, state), ``down`` at
    the end."""
    home = tmp_path_factory.mktemp("home")
    config = home / "cluster.yaml"
    config.write_text(CLUSTER_YAML)
    env = dict(os.environ, HOME=str(home), PYTHONPATH=ROOT,
               JAX_PLATFORMS="cpu",
               # raylets the provider starts get a small, prefaulted store
               RAY_TPU_object_store_memory=str(64 << 20))
    up = _cli(env, "up", str(config))
    assert up.returncode == 0, up.stderr
    assert "cluster cli-up is up" in up.stdout
    assert "workers: 1" in up.stdout
    address = [line.split()[-1] for line in up.stdout.splitlines()
               if "gcs address:" in line][0]
    state_path = home / ".ray_tpu_torch" / "clusters" / "cli-up.json"
    state = json.loads(state_path.read_text())
    assert state["gcs_address"] == address and len(state["pids"]) == 3
    try:
        yield env, address, config, state
    finally:
        if state_path.exists():
            _cli(env, "down", str(config))


def test_up_status_and_jobs_then_down(cli_cluster, tmp_path):
    env, address, config, state = cli_cluster
    status = _cli(env, "status", "--address", address)
    assert status.returncode == 0, status.stderr
    assert status.stdout.startswith(f"2 node(s)  [gcs {address}]")
    assert "cluster: {'CPU': 4.0}" in status.stdout

    done = _cli(env, "job", "--address", address, "submit", "--wait",
                "--timeout", "60", "echo", "hello-from-cli")
    assert done.returncode == 0, done.stderr
    job_id = done.stdout.split()[1]
    assert done.stdout.splitlines()[1:] == [f"{job_id}: SUCCEEDED",
                                           "hello-from-cli"]
    logs = _cli(env, "job", "--address", address, "logs", job_id)
    assert (logs.returncode, logs.stdout) == (0, "hello-from-cli\n")

    sleeper = _cli(env, "job", "--address", address, "submit",
                   "sleep", "600")
    sleeping = sleeper.stdout.split()[1]
    deadline = time.monotonic() + 60
    while True:
        got = _cli(env, "job", "--address", address, "status", sleeping)
        if got.stdout.strip() == "RUNNING" or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert got.stdout.strip() == "RUNNING"
    # the stop signal runs as a 1-CPU task on the job's node, beside
    # the job's own (a node whose every CPU jobs hold cannot stop them,
    # in both packages), so the nodes have two
    stop = _cli(env, "job", "--address", address, "stop", sleeping)
    assert (stop.returncode, stop.stdout) == (0, "stopped\n"), stop.stderr
    listed = _cli(env, "job", "--address", address, "list")
    assert listed.returncode == 0
    rows = [line.split() for line in listed.stdout.splitlines()]
    assert rows[0][:3] == [job_id, "SUCCEEDED", "echo"]
    assert rows[1][:2] == [sleeping, "STOPPED"] or \
        rows[1][:2] == [sleeping, "RUNNING"]  # the signal may still land
    deadline = time.monotonic() + 30
    while _cli(env, "job", "--address", address, "status",
               sleeping).stdout.strip() != "STOPPED":
        assert time.monotonic() < deadline, "the stopped job never ended"
        time.sleep(0.2)
    missing = _cli(env, "job", "--address", address, "status", "nope")
    assert (missing.returncode, missing.stdout) == (1, "NOT_FOUND\n")

    down = _cli(env, "down", str(config))
    assert down.returncode == 0, down.stderr
    assert "cluster torn down" in down.stdout
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in state["pids"]):
        assert time.monotonic() < deadline, "a cluster process survived"
        time.sleep(0.1)
    assert not (config.parent / ".ray_tpu_torch" / "clusters"
                / "cli-up.json").exists()


def test_microbenchmark_json_rows_named_as_jax():
    from ray_tpu._private.ray_perf import main as jax_perf
    from ray_tpu_torch.scripts import cli

    _end_jax_leftovers()
    ray_tpu.init(num_cpus=4)
    try:
        jax_names = [r["name"] for r in jax_perf(duration=0.02)]
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        import contextlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(["microbenchmark", "--json",
                             "--duration", "0.02"]) == 0
    finally:
        ray_tpu_torch.shutdown()
    rows = json.loads(out.getvalue())
    assert [r["name"] for r in rows] == jax_names
    assert len(rows) == 7
    for row in rows:
        assert row["rate"] > 0 and row["runs"] == 3
        assert row["rate_min"] <= row["rate"] <= row["rate_max"]
