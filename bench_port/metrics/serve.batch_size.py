"""Mean requests a forward (the @serve.batch batches of the window)."""


def read(record):
    sizes = [len(b["ids"]) for b in record["batches"]]
    return sum(sizes) / len(sizes) if sizes else None
