"""K1-K3's share of their roofline over the traced steps: the least time
of the launches counted (``work.attention_kernel`` at each launch's
shape) over their device time in the trace, in percent."""

from bench_port.metrics import attention_bound_s


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    device_s = sum(trace["group_s"].get(g, 0.0)
                   for g in ("attn_fwd", "attn_dq", "attn_dkdv"))
    if device_s <= 0:
        return None
    return 100 * attention_bound_s(record["attention_calls"],
                                   record["trace_launches"]) / device_s
