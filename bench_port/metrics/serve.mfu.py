"""Useful forward FLOPs of the batches' prompts (real tokens only, the
head at each prompt's last position) over the time some forward ran
(the union of the batches' forward spans) and the bf16 peak of one H100,
in percent: padding and work no reply needs show as loss."""

from bench_port import work


def read(record):
    spans = sorted((b["start"], b["end"]) for b in record["batches"])
    if not spans:
        return None
    busy, (a, e) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > e:
            busy, a = busy + e - a, start
        e = max(e, end)
    busy += e - a
    served = sum(record["useful_flops"][i] for b in record["batches"]
                 for i in b["ids"])
    return 100 * served / busy / work.PEAK_FLOPS["bfloat16"]
