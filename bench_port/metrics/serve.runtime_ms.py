"""Mean milliseconds a request spends in the runtime and serve's path
outside its queue and its batch's forward: its latency less its wait
for the batch to start less the batch's forward and reply."""


def read(record):
    batch = {i: b for b in record["batches"] for i in b["ids"]}
    rest = [(record["done"][i] - record["due"][i])
            - (b["start"] - record["due"][i]) - (b["end"] - b["start"])
            for i, b in batch.items() if record["done"][i] is not None]
    return 1e3 * sum(rest) / len(rest) if rest else None
