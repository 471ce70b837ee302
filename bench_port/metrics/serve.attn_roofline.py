"""K1's share of its roofline over the traced batches: the least time of
their launches at each batch's padded shape over K1's device time in the
trace, in percent."""

from bench_port import work


def read(record):
    trace = record.get("trace")
    if not trace or trace["group_s"].get("attn_fwd", 0.0) <= 0:
        return None
    bound = 0.0
    for calls in record["attention_calls"]:
        for kernel, b, sq, sk, h, d, causal, n in calls:
            bound += n * work.attention_kernel(kernel, b, sq, sk, h, d,
                                               causal)["bound_s"]
    return 100 * bound / trace["group_s"]["attn_fwd"]
