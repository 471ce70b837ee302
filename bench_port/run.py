"""One run of one benchmark cell, in a new process, on the chips it asks.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration file, its
traffic file (``bench_port/traffic/<traffic>.json``, whose ``kind``
names the driver in ``bench_port/drivers/``) and its limits
(``bench_port/limits/<workload>.json``); runs set-up, the measured
window and the check of ``correct``; prints the numbers compared beside
their limits as the last lines of standard error, and one JSON line as
the last line of standard output. With ``--trace 0`` the metrics are
the cell's end-to-end ones, with ``--trace 1`` its per-layer ones (read
by ``bench_port/metrics/<metric>.py``). Exits 2 without the cards the
cell asks for, and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "bench_port"
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def load_cell(workload: str) -> dict:
    """The cell's manifest entries and files, by the names in
    BENCHMARK.json."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    config = next(c for c in manifest["configs"]
                  if c["name"] == cell["config"])
    conf = json.loads((ROOT / config["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    end_to_end = [m for m in manifest["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    per_layer = [m for m in manifest["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return {"workload": workload, "chips": cell["chips"], "conf": conf,
            "traffic": traffic, "limits": limits["numbers"],
            "end_to_end": end_to_end, "per_layer": per_layer}


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc build is its own ``ray_tpu_torch/ops/_build``)."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def execute(cell: dict, seed: int, seconds: float, trace: bool,
            device: str, process_start: float = PROCESS_START) -> dict:
    """Set-up, window and check of ``cell`` on ``device``; -> the result
    line as a dict (without ``device``)."""
    driver = importlib.import_module(
        f"bench_port.drivers.{cell['traffic']['kind']}")
    out = driver.run({**cell, "seed": seed, "seconds": seconds,
                      "trace": bool(trace)}, device)
    numbers = out["numbers"]
    numbers["missing"] = {"value": float(out["failed"])}
    limits = {**cell["limits"], "missing": {"limit": 0.0}}
    correct = all(name in numbers for name in limits)
    for name, limit in limits.items():
        if name in numbers:
            numbers[name]["limit"] = limit["limit"]
            correct = correct and numbers[name]["value"] <= limit["limit"]
    metrics = {}
    if trace:
        from bench_port.metrics import reader

        for m in cell["per_layer"]:
            value = reader(m["name"])(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out["end_to_end"],
                  "setup_s": out["window_start"] - process_start}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    trace_summary = out["record"].get("trace")
    if trace and trace_summary:
        result["trace"] = trace_summary
    for key in ("errors", "generator_late_ms"):
        if out.get(key):
            result[key] = out[key]
    result["checks"] = {name: {"value": n["value"],
                               "limit": n.get("limit"),
                               **({"at": n["at"]} if "at" in n else {})}
                        for name, n in numbers.items() if name in limits}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    cache_dirs()

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"bench_port: the cell asks for {cell['chips']} CUDA "
              f"device(s); this machine shows {cards}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda")
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {found}", file=sys.stderr)
        return 3
    trace = result.pop("trace", None)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": result.pop("memory_peak_bytes"),
              "power_limit": power_limit()}
    if trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": device}
    if trace:
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
        line["device_groups_s"] = trace["group_s"]
    for key in ("errors", "generator_late_ms"):
        if key in result:
            line[key] = result[key]
    line["checks"] = result["checks"]
    for name, n in result["checks"].items():
        print(f"check {name}: {n['value']!r} limit {n['limit']!r}"
              + (f" (at {n['at']})" if "at" in n else ""), file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
