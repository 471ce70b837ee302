"""CLI — `python -m ray_tpu_torch <command>`.

Reference: python/ray/scripts/scripts.py (`ray start/stop/status/memory/
timeline/microbenchmark`). In-process runtime means start/stop manage a
head "session" in this process; status/memory/timeline introspect it.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_status(args) -> int:
    if getattr(args, "address", None):
        # a live process cluster: read the GCS view over the wire
        from ray_tpu_torch.cluster.rpc import RpcClient

        client = RpcClient(args.address)
        try:
            view = client.call("cluster_view", timeout=10.0)
            summary = client.call("job_view", timeout=10.0)
        finally:
            client.close()
        nodes = view["nodes"]
        print(f"{len(nodes)} node(s)  [gcs {args.address}]")
        print(f"  actors={summary['actors']} objects={summary['objects']}"
              f" pgs={summary['pgs']}")
        total: dict = {}
        avail: dict = {}
        for nid, info in nodes.items():
            # lifecycle: ALIVE -> (DRAINING) -> DEAD; pre-drain-plane
            # GCS versions lack the "state" key, so fall back to alive
            state = info.get("state",
                             "ALIVE" if info["alive"] else "DEAD")
            print(f"  {nid[:16]} {state} {info['resources']}")
            ov = info.get("overload") or {}
            rpc_ov = ov.get("rpc") or {}
            breakers = ov.get("breakers") or {}
            open_breakers = sum(
                1 for b in breakers.values()
                if b.get("state") != "closed")
            print(f"    overload: shed="
                  f"{rpc_ov.get('shed_queue_full', 0)}+"
                  f"{rpc_ov.get('shed_deadline', 0)} "
                  f"tasks_shed={ov.get('tasks_shed', 0)} "
                  f"push_shed={ov.get('push_shed', 0)} "
                  f"breakers={len(breakers)}"
                  f" (open={open_breakers})")
            srv = info.get("serve") or {}
            print(f"    serve: unhealthy="
                  f"{int(srv.get('replicas_unhealthy', 0))} "
                  f"drains={int(srv.get('drains_completed', 0))} "
                  f"router_excluded="
                  f"{int(srv.get('router_excluded', 0))} "
                  f"backpressured="
                  f"{int(srv.get('requests_backpressured', 0))}")
            integ = info.get("integrity") or {}
            print(f"    integrity: detected="
                  f"{int(integ.get('corruption_detected', 0))} "
                  f"discarded="
                  f"{int(integ.get('corrupt_replicas_discarded', 0))} "
                  f"orphans_adopted="
                  f"{int(integ.get('orphans_adopted', 0))} "
                  f"verified_mib="
                  f"{integ.get('bytes_verified', 0) / 2**20:.1f}")
            pool = info.get("worker_pool") or {}
            print(f"    worker pool: idle="
                  f"{int(pool.get('warm_idle', 0))}/"
                  f"{int(pool.get('warm_size', 0))} "
                  f"hits={int(pool.get('warm_hits', 0))} "
                  f"misses={int(pool.get('warm_misses', 0))} "
                  f"returned={int(pool.get('warm_returned', 0))} "
                  f"reaped={int(pool.get('warm_reaped', 0))} "
                  f"create_p50_ms={pool.get('create_ms_p50') or 0}")
            thr = info.get("threads") or {}
            if thr:
                # thread roots use the raycheck RC16/RC17 report naming
                shown = sorted(set(thr.values()))
                extra = (f" +{len(shown) - 4} more"
                         if len(shown) > 4 else "")
                print(f"    threads: {len(thr)} live, roots: "
                      f"{', '.join(shown[:4])}{extra}")
            if info["alive"]:
                for k, v in info["resources"].items():
                    total[k] = total.get(k, 0.0) + v
                for k, v in info["available"].items():
                    avail[k] = avail.get(k, 0.0) + v
        print("cluster:", total)
        print("available:", avail)
        gcs_ov = view.get("overload") or {}
        print(f"gcs overload: shed_queue_full="
              f"{gcs_ov.get('shed_queue_full', 0)} shed_deadline="
              f"{gcs_ov.get('shed_deadline', 0)} replies_dropped="
              f"{gcs_ov.get('replies_dropped', 0)}")
        batch = view.get("actor_batch") or {}
        print(f"gcs actor batches: creates_batched="
              f"{int(batch.get('creates_batched', 0))} "
              f"kills_batched={int(batch.get('kills_batched', 0))}")
        drain = view.get("drain") or {}
        print(f"gcs drain: nodes_draining="
              f"{int(drain.get('nodes_draining', 0))} "
              f"drains_completed="
              f"{int(drain.get('drains_completed', 0))} "
              f"preemption_notices="
              f"{int(drain.get('preemption_notices', 0))} "
              f"objects_rereplicated="
              f"{int(drain.get('objects_rereplicated', 0))}")
        return 0
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    from ray_tpu_torch import gcs

    nodes = gcs.nodes()
    print(f"{len(nodes)} node(s)")
    for n in nodes:
        state = "ALIVE" if n["Alive"] else "DEAD"
        print(f"  {n['NodeID'][:16]} {state} {n['Resources']}")
    print("cluster:", ray_tpu_torch.cluster_resources())
    print("available:", ray_tpu_torch.available_resources())
    return 0


def cmd_memory(args) -> int:
    import ray_tpu_torch
    from ray_tpu_torch import gcs

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    print(gcs.memory_summary())
    return 0


def cmd_timeline(args) -> int:
    if getattr(args, "address", None):
        # merge every node's flight-recorder ring (clock-offset
        # corrected) into one chrome://tracing document
        from ray_tpu_torch.cluster.rpc import RpcClient
        from ray_tpu_torch.observability.flight_recorder import (
            merge_chrome_trace)

        client = RpcClient(args.address)
        try:
            result = client.call("collect_timeline",
                                 per_node_timeout_s=args.per_node_timeout,
                                 timeout=args.per_node_timeout * 4 + 10.0)
        finally:
            client.close()
        dumps = result["dumps"]
        trace = merge_chrome_trace(dumps)
        with open(args.output, "w") as f:
            json.dump(trace, f)
        reachable = sum(1 for d in dumps if "error" not in d)
        spans = sum(len(d.get("spans") or []) for d in dumps)
        print(f"wrote merged Chrome trace to {args.output} "
              f"({reachable}/{len(dumps)} node(s), {spans} span(s), "
              f"{len(trace['traceEvents'])} trace event(s))")
        return 0 if reachable == len(dumps) else 1
    from ray_tpu_torch.observability import timeline

    path = timeline(args.output)
    print(f"wrote Chrome trace to {path}")
    return 0


def cmd_microbenchmark(args) -> int:
    from ray_tpu_torch._private.ray_perf import main as perf_main

    rows = perf_main(duration=args.duration)
    if args.json:
        print(json.dumps(rows))
    else:
        for row in rows:
            print(f"{row['name']:>40}: {row['rate']:>12.1f} /s")
    return 0


def cmd_metrics(args) -> int:
    from ray_tpu_torch.observability import prometheus_text

    print(prometheus_text())
    return 0


def cmd_up(args) -> int:
    """`ray up cluster.yaml` (reference: scripts.py up →
    commands.create_or_update_cluster)."""
    from ray_tpu_torch.autoscaler.commands import create_or_update_cluster

    handle = create_or_update_cluster(args.cluster_config)
    print(f"cluster {handle.name} is up")
    print(f"  head: {handle.head_id} @ {handle.head_node_ip()}")
    print(f"  workers: {len(handle.worker_ids())}")
    if getattr(handle.provider, "gcs_address", None):
        print(f"  gcs address: {handle.provider.gcs_address}")
    if args.monitor:
        handle.start_monitor()
        print("  autoscaler monitor running")
        try:
            import time

            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return 0


def cmd_down(args) -> int:
    """`ray down cluster.yaml`."""
    from ray_tpu_torch.autoscaler.commands import teardown_cluster

    teardown_cluster(args.cluster_config,
                     keep_min_workers=args.keep_min_workers)
    print("cluster torn down")
    return 0


def cmd_job(args) -> int:
    """`ray job submit/status/logs/list/stop` (reference:
    dashboard/modules/job/cli.py)."""
    from ray_tpu_torch.cluster.job_manager import JobSubmissionClient

    client = JobSubmissionClient(args.address)
    try:
        if args.job_command == "submit":
            job_id = client.submit_job(
                entrypoint=" ".join(args.entrypoint))
            print(f"submitted {job_id}")
            if args.wait:
                status = client.wait_until_finish(job_id,
                                                  timeout=args.timeout)
                print(f"{job_id}: {status}")
                print(client.get_job_logs(job_id), end="")
                return 0 if status == "SUCCEEDED" else 1
        elif args.job_command == "status":
            status = client.get_job_status(args.job_id)
            print(status or "NOT_FOUND")
            if status is None:
                return 1
        elif args.job_command == "logs":
            print(client.get_job_logs(args.job_id), end="")
        elif args.job_command == "list":
            for row in client.list_jobs():
                print(f"{row['job_id']:>28} {row['status']:>10} "
                      f"{row['entrypoint']}")
        elif args.job_command == "stop":
            if client.stop_job(args.job_id):
                print("stopped")
            else:
                print("not running")
                return 1
    finally:
        client.close()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch command line")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("status", help="cluster resource status")
    p.add_argument("--address", default=None,
                   help="GCS address of a process cluster (host:port); "
                        "omit to inspect the in-process runtime")
    sub.add_parser("memory", help="object ownership dump")
    p = sub.add_parser("timeline", help="dump Chrome trace")
    p.add_argument("-o", "--output", default="ray_tpu_timeline.json")
    p.add_argument("--address", default=None,
                   help="GCS address (host:port): merge every node's "
                        "flight-recorder buffer into one cluster-wide "
                        "trace; omit to dump the local profiler")
    p.add_argument("--per-node-timeout", type=float, default=5.0,
                   help="seconds the GCS waits on each node's buffer")
    p = sub.add_parser("microbenchmark", help="run the perf matrix")
    p.add_argument("--duration", type=float, default=1.0)
    p.add_argument("--json", action="store_true")
    sub.add_parser("metrics", help="print Prometheus metrics")
    p = sub.add_parser("up", help="bring a cluster up from a YAML config")
    p.add_argument("cluster_config")
    p.add_argument("--monitor", action="store_true",
                   help="keep running the autoscaler reconcile loop")
    p = sub.add_parser("down", help="tear a cluster down")
    p.add_argument("cluster_config")
    p.add_argument("--keep-min-workers", action="store_true")
    p = sub.add_parser("job", help="submit and manage cluster jobs")
    p.add_argument("--address", required=True,
                   help="GCS address (host:port)")
    jsub = p.add_subparsers(dest="job_command", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--wait", action="store_true")
    js.add_argument("--timeout", type=float, default=300.0)
    js.add_argument("entrypoint", nargs="+")
    for name in ("status", "logs", "stop"):
        jp = jsub.add_parser(name)
        jp.add_argument("job_id")
    jsub.add_parser("list")
    args = parser.parse_args(argv)
    return {
        "status": cmd_status,
        "memory": cmd_memory,
        "timeline": cmd_timeline,
        "microbenchmark": cmd_microbenchmark,
        "metrics": cmd_metrics,
        "up": cmd_up,
        "down": cmd_down,
        "job": cmd_job,
    }[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
