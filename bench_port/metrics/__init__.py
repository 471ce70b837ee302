"""One reader per per-layer metric, in a file named after the metric:
``read(record) -> float | None`` over the record a run's driver keeps
(its steps or requests and batches, and with ``--trace 1`` the device
trace). A reader that finds nothing to read returns None, and the run
leaves the metric out of its line."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name}", HERE / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def untraced_steps(record: dict) -> list:
    """The window's steps outside the traced stretch, after the first
    (whose start the window's opening shares)."""
    return [s for s in record["steps"][1:] if not s["traced"]]


def attention_bound_s(calls: list, launches: dict) -> float:
    """Least seconds of the attention launches counted, each at the shape
    its kernel is launched with in ``calls``."""
    from bench_port import work

    bound = {}
    for kernel, b, sq, sk, h, d, causal, _ in calls:
        bound[kernel] = work.attention_kernel(kernel, b, sq, sk, h, d,
                                              causal)["bound_s"]
    return sum(launches[k] * bound[k] for k in bound)
