"""Find the scoring cell's knee: the highest Poisson rate at which the
backlog does not grow over the window.

    python3 -m bench_port.sweep --workload <name> --rates 4,6,8
        [--seconds 20] [--seed n]

Runs the cell's driver once per rate in one process, without its check
of ``correct`` (``check_sample`` 0), and prints one JSON line per rate:
the latency median and 95th percentile, the median latency of the
first and of the last quarter of the requests (a backlog that grows
makes the last far longer), the mean batch, the generator's lateness.
The cell's traffic file then fixes its rate at 0.8 x the knee found.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=2 ** 31 + 11)
    args = parser.parse_args(argv)

    import torch

    from bench_port import run
    from bench_port.drivers import score

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = {**cell["traffic"], "rate_per_s": rate, "check_sample": 0}
        out = score.run({**cell, "traffic": traffic, "seed": args.seed,
                         "seconds": args.seconds, "trace": False}, "cuda")
        lat = out["record"]["latency_ms"]
        quarter = max(1, len(lat) // 4)
        sizes = [len(b["ids"]) for b in out["record"]["batches"]]
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat),
            "failed": out["failed"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "first_quarter_p50_ms": float(np.median(lat[:quarter])),
            "last_quarter_p50_ms": float(np.median(lat[-quarter:])),
            "mean_batch": sum(sizes) / len(sizes),
            "generator_late_ms": out["generator_late_ms"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
