"""Mean milliseconds from a request's due time to the start of its
batch's forward (one host clock: the thread tier)."""


def read(record):
    start = {i: b["start"] for b in record["batches"] for i in b["ids"]}
    waits = [start[i] - record["due"][i] for i in range(len(record["due"]))
             if i in start]
    return 1e3 * sum(waits) / len(waits) if waits else None
