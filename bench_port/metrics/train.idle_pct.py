"""Share of the traced steps' window in which no operation ran on the
device, in percent (torch.profiler)."""


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    return 100 * (1 - trace["busy_s"] / trace["window_s"])
