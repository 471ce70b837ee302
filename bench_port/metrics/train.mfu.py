"""Model FLOPs of a step over its window time and the bf16 peak of one
H100 (989 TFLOP/s), in percent; recomputation not counted."""

from bench_port import work
from bench_port.metrics import untraced_steps


def read(record):
    steps = untraced_steps(record)
    if not steps:
        return None
    step_s = sum(s["end"] - s["begin"] for s in steps) / len(steps)
    return 100 * record["flops_per_step"] / step_s / work.PEAK_FLOPS[
        "bfloat16"]
