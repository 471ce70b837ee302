"""The port's job submission against the JAX package's, on the CPU.

The 5 scenarios of tests/test_job_submission.py on the port's
``ProcessCluster(gcs_device="cpu")``, each beside the same entrypoint
on the JAX package's ``ProcessCluster``: the status sequences (every
status a poll saw, in order) and the logs are equal. Each job is
submitted while two tasks hold the node's two CPUs, so it stays PENDING
until the test lets them end, and its entrypoint waits for a gate file
that the test creates once it has seen the job RUNNING: every side's
polls see PENDING, RUNNING and the end, whatever the host's load.
``test_list_jobs_and_dashboard_route`` also reads each cluster's jobs
through its own package's dashboard head (``/api/jobs``).

Then the slice as a whole: a submitted job whose entrypoint brings up
the port's runtime on the CPU and serves ``ModelConfig.debug()``,
converted from the JAX package's weights, through an actor. Its logits
equal the JAX forward within 1e-4 absolute and relative, the whole-model
fp32 tolerance of tests/test_torch_model.py. Every wait is bounded.
"""

import glob
import os
import pickle
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.cluster.job_manager import (
    JobSubmissionClient as JaxJobSubmissionClient,
)
from ray_tpu.cluster.process_cluster import ProcessCluster as JaxProcessCluster
from ray_tpu_torch.cluster.job_manager import JobSubmissionClient
from ray_tpu_torch.cluster.process_cluster import ProcessCluster

# the CPU holders run in the raylets' workers, which cannot import tests/
cloudpickle.register_pickle_by_value(sys.modules[__name__])

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERMINAL = ("SUCCEEDED", "FAILED", "STOPPED")
NODE_CPUS = 2


def _hold_cpu(started, release):
    """A 1-CPU task that runs until ``release`` exists."""
    import pathlib

    pathlib.Path(f"{started}.{os.getpid()}").touch()
    deadline = time.monotonic() + 60
    while not os.path.exists(release) and time.monotonic() < deadline:
        time.sleep(0.01)
    return os.path.exists(release)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """(side, cluster, client) for the JAX package and the port, and a
    directory for gate files."""
    out = []
    jax_cluster = JaxProcessCluster(heartbeat_period_ms=100,
                                    num_heartbeats_timeout=20)
    try:
        jax_cluster.add_node(num_cpus=NODE_CPUS,
                             object_store_memory=64 << 20)
        jax_cluster.wait_for_nodes(1)
        port_cluster = ProcessCluster(heartbeat_period_ms=100,
                                      num_heartbeats_timeout=20,
                                      gcs_device="cpu")
        try:
            port_cluster.add_node(num_cpus=NODE_CPUS,
                                  object_store_memory=64 << 20)
            port_cluster.wait_for_nodes(1)
            out = [("jax", jax_cluster,
                    JaxJobSubmissionClient(jax_cluster.gcs_address)),
                   ("torch", port_cluster,
                    JobSubmissionClient(port_cluster.gcs_address))]
            yield out, tmp_path_factory.mktemp("gates")
        finally:
            for _, _, client in out:
                client.close()
            port_cluster.shutdown()
    finally:
        jax_cluster.shutdown()


def _gated(gate, command: str) -> str:
    return (f"while [ ! -e {gate} ]; do sleep 0.02; done; {command}")


def _run(client, gate, entrypoint, stop=False, **submit_kwargs):
    """Submit with the node's CPUs held, let them go, poll until RUNNING,
    open the gate (or stop the job), and poll to the end -> (job_id,
    statuses seen in order, info, logs)."""
    started, release = f"{gate}-held", f"{gate}-release"
    holders = [client._client.submit(_hold_cpu, (started, release))
               for _ in range(NODE_CPUS)]
    deadline = time.monotonic() + 60
    while len(glob.glob(f"{started}.*")) < NODE_CPUS:
        assert time.monotonic() < deadline, "the CPU holders never ran"
        time.sleep(0.01)
    job_id = client.submit_job(entrypoint=entrypoint, **submit_kwargs)
    seen = [client.get_job_status(job_id)]
    open(release, "w").close()
    assert all(client._client.get(h, timeout=60.0) for h in holders)

    def poll_until(done, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = client.get_job_status(job_id)
            if status != seen[-1]:
                seen.append(status)
            if done(status):
                return
            time.sleep(0.01)
        pytest.fail(f"job {job_id} stuck at {seen}")

    poll_until(lambda s: s == "RUNNING", 60)
    if stop:
        assert client.stop_job(job_id) is True
    else:
        gate.touch()
    poll_until(lambda s: s in TERMINAL, 60)
    return job_id, seen, client.get_job_info(job_id), \
        client.get_job_logs(job_id)


def _on_both(clusters, name, command, stop=False, **submit_kwargs):
    sides, gates = clusters
    out = []
    for side, _, client in sides:
        gate = gates / f"{name}-{side}"
        out.append(_run(client, gate, _gated(gate, command), stop=stop,
                        **submit_kwargs))
    (_, jax_seen, jax_info, jax_logs), port = out
    assert port[1] == jax_seen
    assert port[3] == jax_logs
    assert port[2].get("returncode") == jax_info.get("returncode")
    return port


def test_job_succeeds_with_logs(clusters):
    job_id, seen, info, logs = _on_both(
        clusters, "ok", "echo hello-from-job && echo line2")
    assert seen == ["PENDING", "RUNNING", "SUCCEEDED"]
    assert logs == "hello-from-job\nline2\n"
    assert info["returncode"] == 0
    assert info["entrypoint"].startswith("while")


def test_job_failure_reported(clusters):
    job_id, seen, info, logs = _on_both(
        clusters, "fail", f"{sys.executable} -c 'import sys; "
        "print(\"dying\"); sys.exit(3)'")
    assert seen == ["PENDING", "RUNNING", "FAILED"]
    assert info["returncode"] == 3
    assert "dying" in logs


def test_job_env_vars_and_id(clusters):
    job_id, seen, info, logs = _on_both(
        clusters, "env", f"{sys.executable} -c 'import os; "
        "print(os.environ[\"MY_FLAG\"], os.environ[\"RAY_TPU_JOB_ID\"])'",
        runtime_env={"env_vars": {"MY_FLAG": "on"}}, job_id="custom-job-1")
    assert job_id == "custom-job-1"
    assert seen == ["PENDING", "RUNNING", "SUCCEEDED"]
    assert logs == "on custom-job-1\n"
    for _, _, client in clusters[0]:
        with pytest.raises(ValueError, match="already exists"):
            client.submit_job(entrypoint="true", job_id="custom-job-1")


def test_job_stop(clusters):
    job_id, seen, info, logs = _on_both(
        clusters, "stop", "echo never-reached", stop=True)
    assert seen == ["PENDING", "RUNNING", "STOPPED"]
    assert logs == ""
    assert info["returncode"] < 0
    # a stopped job is not running: a second stop is refused
    assert clusters[0][1][2].stop_job(job_id) is False


def test_job_stop_on_a_node_whose_only_cpu_the_job_holds():
    """stop_job reaches a job whose entrypoint holds its node's only CPU
    (and only pooled worker): the signal task demands no resource, so it
    neither queues behind the job for the CPU nor waits for the worker.
    The JAX package keeps the fault (ROADMAP Queue C: its signal task
    takes a CPU, and stop_job raises after 30 s); every wait here is
    bounded."""
    cluster = ProcessCluster(heartbeat_period_ms=100,
                             num_heartbeats_timeout=20, gcs_device="cpu")
    client = None
    try:
        cluster.add_node(num_cpus=1, object_store_memory=64 << 20)
        cluster.wait_for_nodes(1)
        client = JobSubmissionClient(cluster.gcs_address)
        job_id = client.submit_job(entrypoint="sleep 120")
        deadline = time.monotonic() + 60
        while client.get_job_status(job_id) != "RUNNING":
            assert time.monotonic() < deadline, "the job never ran"
            time.sleep(0.05)
        assert client.stop_job(job_id) is True
        assert client.wait_until_finish(job_id, timeout=30) == "STOPPED"
        assert client.get_job_info(job_id)["returncode"] < 0
    finally:
        if client is not None:
            client.close()
        cluster.shutdown()


def test_list_jobs_and_dashboard_route(clusters):
    """Every job of this module, in submit order, with equal statuses on
    both packages: from ``list_jobs`` and from each package's dashboard
    head's ``/api/jobs``, which serves the same rows."""
    import json
    import urllib.request

    from ray_tpu.observability.dashboard_head import (
        DashboardHead as JaxDashboardHead,
    )
    from ray_tpu_torch.observability.dashboard_head import DashboardHead

    def row(r):  # a generated id differs between the two clusters
        job_id = r["job_id"]
        return ("raysubmit_*" if job_id.startswith("raysubmit_")
                else job_id, r["status"], r["entrypoint"].split("; ", 1)[1])

    rows = [[row(r) for r in client.list_jobs()]
            for _, _, client in clusters[0]]
    assert rows[1] == rows[0]
    assert len(rows[1]) >= 4
    assert (("custom-job-1", "SUCCEEDED") in
            [(r[0], r[1]) for r in rows[1]])

    served = []
    for (_, cluster, _), head_cls in zip(clusters[0],
                                         (JaxDashboardHead, DashboardHead)):
        head = head_cls(cluster.gcs_address)
        try:
            with urllib.request.urlopen(head.url + "/api/jobs",
                                        timeout=10) as r:
                served.append([row(j) for j in json.loads(r.read())])
        finally:
            head.stop()
    assert served[1] == served[0]
    assert sorted(served[1]) == sorted(rows[1])


# ------------------------------------------------- the slice as a whole


_SERVE_DEBUG = '''
import pickle, sys

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.training import build_forward

params_np, tokens = pickle.load(open(sys.argv[1], "rb"))
ray_tpu_torch.init(num_cpus=2, device="cpu")


@ray_tpu_torch.remote
class ModelServer:
    def __init__(self, params_np):
        self.cfg = ttfm.ModelConfig.debug()
        self.params = params_from_jax(params_np, self.cfg, "cpu")
        self.fwd = build_forward(self.cfg, device="cpu")

    def forward(self, tokens):
        return self.fwd(self.params, tokens)


server = ModelServer.remote(params_np)
logits = ray_tpu_torch.get([server.forward.remote(tokens)
                            for _ in range(2)], timeout=120)
np.save(sys.argv[2], np.stack([out.numpy() for out in logits]))
print("served", len(logits), "requests", flush=True)
ray_tpu_torch.shutdown()
'''


def test_job_serves_debug_model_like_jax(clusters, tmp_path):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm
    from ray_tpu.models.training import build_forward as j_build_forward

    jcfg = jtfm.ModelConfig.debug(remat=False)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(4))
    params_np = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, 96)).astype(np.int32)
    ref = np.asarray(j_build_forward(jcfg)(jparams, jnp.asarray(tokens)))

    inputs, script = tmp_path / "inputs.pkl", tmp_path / "serve_debug.py"
    with open(inputs, "wb") as f:
        pickle.dump((params_np, tokens), f)
    script.write_text(_SERVE_DEBUG)
    out = tmp_path / "logits.npy"
    client = clusters[0][1][2]
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} {script} {inputs} {out}",
        runtime_env={"env_vars": {"PYTHONPATH": ROOT}})
    assert client.wait_until_finish(job_id, timeout=120) == "SUCCEEDED", \
        client.get_job_logs(job_id)
    assert "served 2 requests" in client.get_job_logs(job_id)
    logits = np.load(out)
    assert logits.shape == (2,) + ref.shape
    for got in logits:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert not ray_tpu_torch.is_initialized()  # the job's own runtime
