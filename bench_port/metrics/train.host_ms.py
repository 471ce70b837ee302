"""Window milliseconds a step spends outside the step call: the feed, the
report through the Trainer's session, and the loop (host clock)."""

from bench_port.metrics import untraced_steps


def read(record):
    steps = untraced_steps(record)
    if not steps:
        return None
    outside = [(s["end"] - s["begin"]) - (s["call1"] - s["call0"])
               for s in steps]
    return 1e3 * sum(outside) / len(outside)
