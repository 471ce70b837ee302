"""Job submission over the process cluster.

Reference: dashboard/modules/job/ (JobSubmissionClient, job_manager.py)
— submit a shell entrypoint to the cluster, track PENDING/RUNNING/
SUCCEEDED/FAILED/STOPPED status, fetch logs, stop it. Here the job runs
inside a worker process on some node; status and logs live in the GCS
KV (namespace `_job`), so any client connected to the GCS can observe
them; stop routes a signal task to the job's node.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

JOB_NS = "_job"


def _run_job_entrypoint(job_id: str, entrypoint: str, gcs_address: str,
                        env_vars: Optional[Dict[str, str]] = None) -> int:
    """Executes ON A WORKER PROCESS: runs the entrypoint as a shell
    subprocess in its own process group, streaming status+logs to the
    GCS KV."""
    import os
    import subprocess

    from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient

    gcs = ReconnectingRpcClient(gcs_address)

    def put(key: str, value: bytes) -> None:
        gcs.call("kv_put", ns=JOB_NS, key=key.encode(), value=value,
                 timeout=10.0)

    def set_status(status: str, **extra) -> None:
        # job rows carry user-facing wall-clock timestamps (listed and
        # sorted across processes; monotonic values from different
        # hosts are not comparable)
        row = {"job_id": job_id, "status": status,
               "entrypoint": entrypoint,
               "timestamp": time.time(),  # raycheck: disable=RC02
               **extra}
        put(f"status/{job_id}", json.dumps(row).encode())

    env = dict(os.environ)
    env.update(env_vars or {})
    env["RAY_TPU_JOB_ID"] = job_id
    try:
        proc = subprocess.Popen(
            entrypoint, shell=True, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True)  # its own pgid: stop kills the tree
        set_status("RUNNING", pid=proc.pid, pgid=proc.pid,
                   node_id=os.environ.get("RAY_TPU_NODE_ID", ""),
                   hostpid=os.getpid())
        lines: List[str] = []
        for raw in iter(proc.stdout.readline, b""):
            lines.append(raw.decode("utf-8", "replace"))
            if len(lines) % 20 == 0:  # stream logs incrementally
                put(f"logs/{job_id}", "".join(lines).encode())
        rc = proc.wait()
        put(f"logs/{job_id}", "".join(lines).encode())
        if rc == 0:
            set_status("SUCCEEDED", returncode=0)
        elif rc < 0:
            set_status("STOPPED", returncode=rc)
        else:
            set_status("FAILED", returncode=rc)
        return rc
    except Exception as e:  # noqa: BLE001 — the job row must say why
        set_status("FAILED", error=repr(e))
        raise
    finally:
        gcs.close()


def _signal_job(pgid: int, sig: int) -> bool:
    """Executes on the job's node: signal the entrypoint's process
    group."""
    import os
    import signal as _signal

    try:
        os.killpg(pgid, sig or _signal.SIGTERM)
        return True
    except ProcessLookupError:
        return False


def list_job_rows(kv_keys_fn, kv_get_fn) -> List[dict]:
    """Shared job-table listing over any KV transport — the client SDK
    and the dashboard head must not drift on key layout/row schema."""
    out = []
    for key in kv_keys_fn(b"status/"):
        raw = kv_get_fn(key)
        if raw is not None:
            out.append(json.loads(raw))
    return sorted(out, key=lambda r: r.get("timestamp", 0))


class JobSubmissionClient:
    """reference: dashboard/modules/job/sdk.py JobSubmissionClient —
    the same verbs over the process cluster's GCS."""

    def __init__(self, gcs_address: str):
        from ray_tpu_torch.cluster.process_cluster import ClusterClient

        self.gcs_address = gcs_address
        self._client = ClusterClient(gcs_address)
        self._refs: Dict[str, Any] = {}  # job_id -> client-side ref

    # ----------------------------------------------------------- submit
    def submit_job(self, *, entrypoint: str,
                   job_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None) -> str:
        import os

        job_id = job_id or f"raysubmit_{os.urandom(6).hex()}"
        if self.get_job_status(job_id) is not None:
            raise ValueError(f"job {job_id!r} already exists")
        env_vars = (runtime_env or {}).get("env_vars")
        # user-facing wall-clock row timestamp (see set_status above)
        row = {"job_id": job_id, "status": "PENDING",
               "entrypoint": entrypoint,
               "timestamp": time.time()}  # raycheck: disable=RC02
        self._client.kv_put(f"status/{job_id}".encode(),
                            json.dumps(row).encode(), ns=JOB_NS)
        ref = self._client.submit(
            _run_job_entrypoint,
            (job_id, entrypoint, self.gcs_address, env_vars))
        self._refs[job_id] = ref
        return job_id

    # ------------------------------------------------------------ status
    def get_job_status(self, job_id: str) -> Optional[str]:
        info = self.get_job_info(job_id)
        return None if info is None else info["status"]

    def get_job_info(self, job_id: str) -> Optional[dict]:
        raw = self._client.kv_get(f"status/{job_id}".encode(), ns=JOB_NS)
        return None if raw is None else json.loads(raw)

    def get_job_logs(self, job_id: str) -> str:
        raw = self._client.kv_get(f"logs/{job_id}".encode(), ns=JOB_NS)
        return "" if raw is None else raw.decode("utf-8", "replace")

    def list_jobs(self) -> List[dict]:
        return list_job_rows(
            lambda prefix: self._client.kv_keys(prefix, ns=JOB_NS),
            lambda key: self._client.kv_get(key, ns=JOB_NS))

    def wait_until_finish(self, job_id: str, timeout: float = 60.0
                          ) -> Optional[str]:
        deadline = time.monotonic() + timeout
        terminal = {"SUCCEEDED", "FAILED", "STOPPED"}
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in terminal:
                return status
            time.sleep(0.1)
        return self.get_job_status(job_id)

    # -------------------------------------------------------------- stop
    def stop_job(self, job_id: str, sig: int = 0) -> bool:
        """SIGTERM the entrypoint's process group on its node
        (reference: job_manager stop_job)."""
        info = self.get_job_info(job_id)
        if info is None or info["status"] not in ("RUNNING", "PENDING"):
            return False
        pgid = info.get("pgid")
        node_id = info.get("node_id") or None
        if pgid is None:
            return False
        ref = self._client.submit(_signal_job, (pgid, sig),
                                  node_id=node_id)
        return bool(self._client.get(ref, timeout=30.0))

    def close(self) -> None:
        self._client.close()
