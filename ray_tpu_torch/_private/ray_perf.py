"""Microbenchmark matrix (reference: python/ray/_private/ray_perf.py:93 —
the rows of release_logs/*/microbenchmark.json). Invoked by the CLI
(`python -m ray_tpu_torch microbenchmark`) and importable for bench.py."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np

import ray_tpu_torch


def _timeit(name: str, fn: Callable[[], int], duration: float = 1.0,
            repeats: int = 3) -> Dict[str, float]:
    """Median rate over ``repeats`` runs plus the relative spread
    (max-min)/median, so run-to-run drift is visible in the artifact
    instead of silently absorbed."""
    # warmup
    fn()
    rates = []
    for _ in range(repeats):
        start = time.perf_counter()
        count = 0
        while time.perf_counter() - start < duration:
            count += fn()
        rates.append(count / (time.perf_counter() - start))
    rates.sort()
    median = rates[len(rates) // 2]
    spread = (rates[-1] - rates[0]) / median if median else 0.0
    return {"name": name, "rate": median,
            "rate_min": rates[0], "rate_max": rates[-1],
            "spread": round(spread, 4), "runs": repeats,
            "elapsed_s": duration * repeats}


def main(duration: float = 1.0) -> List[Dict[str, float]]:
    results = []
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()

    @ray_tpu_torch.remote
    def tiny():
        return b"ok"

    def single_client_tasks_async():
        n = 500
        ray_tpu_torch.get([tiny.remote() for _ in range(n)])
        return n

    results.append(_timeit("single_client_tasks_async",
                           single_client_tasks_async, duration))

    def multi_client_tasks_async():
        # reference microbenchmark.json row: N concurrent submitters
        # pushing tiny tasks — here N threads sharing the runtime, the
        # in-process analogue of several submitting processes
        import concurrent.futures as cf

        n_clients, per_client = 4, 125

        def one_client(_):
            ray_tpu_torch.get([tiny.remote() for _ in range(per_client)])
            return per_client

        with cf.ThreadPoolExecutor(n_clients) as pool:
            return sum(pool.map(one_client, range(n_clients)))

    results.append(_timeit("multi_client_tasks_async",
                           multi_client_tasks_async, duration))

    @ray_tpu_torch.remote
    class Actor:
        def ping(self):
            return b"ok"

    actor = Actor.remote()

    def actor_calls_sync():
        ray_tpu_torch.get([actor.ping.remote()])
        return 1

    results.append(_timeit("1_1_actor_calls_sync", actor_calls_sync,
                           duration))

    def actor_calls_async():
        n = 200
        ray_tpu_torch.get([actor.ping.remote() for _ in range(n)])
        return n

    results.append(_timeit("1_1_actor_calls_async", actor_calls_async,
                           duration))

    actors = [Actor.remote() for _ in range(8)]

    def n_n_actor_calls_async():
        n = 0
        refs = []
        for a in actors:
            refs.extend(a.ping.remote() for _ in range(50))
            n += 50
        ray_tpu_torch.get(refs)
        return n

    results.append(_timeit("n_n_actor_calls_async", n_n_actor_calls_async,
                           duration))

    payload = np.zeros(1024 * 1024, dtype=np.uint8)  # 1 MiB

    def put_gigabytes():
        n = 64
        for _ in range(n):
            ray_tpu_torch.put(payload)
        return n  # MiB

    r = _timeit("single_client_put_MiB_per_s", put_gigabytes, duration)
    results.append(r)

    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )

    def pg_create_removal():
        pg = placement_group([{"CPU": 0.01}])
        pg.wait(5)
        remove_placement_group(pg)
        return 1

    results.append(_timeit("placement_group_create_removal",
                           pg_create_removal, duration))
    return results


if __name__ == "__main__":
    for row in main():
        print(f"{row['name']:>40}: {row['rate']:>12.1f} /s")
