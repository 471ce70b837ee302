"""The general generator of scoring traffic (``"kind": "score"``): an open
loop of prompts through ``ray_tpu_torch.serve``.

Set-up: a one-GPU in-process cluster (thread-tier raylets), ``serve``,
and one replica (``num_gpus`` 1) of a deployment whose ``@serve.batch``
method right-pads a batch to its longest prompt rounded up to
``pad_multiple`` and replies with each prompt's logits at its last real
position, from the family's inference forward on weights made from the
seed. The deployment runs one forward at a time (a lock around the
card's work), as Ray Serve runs one batch at a time per replica: the
port's batcher flushes each batch on its own timer thread, and forwards
that overlap in two threads contend for the interpreter lock while the
card idles. The shapes the traffic can form are warmed, then one
request crosses the whole path.

The window: ``rate_per_s`` x ``--seconds`` requests, each sent through a
handle when it is due, whatever came back. Their due times are a Poisson
process over the window drawn from the seed: given their number, the
arrival times of a Poisson process are independent uniform draws,
sorted. Their prompt lengths are the log-normal law's quantiles,
clipped, the same set for every seed in an order of the seed's, so that
the seed moves when the work comes and not how much there is; the
tokens are the seed's. Each request is timed from when it was due until
its reply is in hand.

After the window, a sample of the answers, drawn from the seed with the
longest request in it, is held against the float32 reference. The
per-layer metrics of the host path (queue, batch, runtime, forward) read
the window's own batches, which no profiler slows. With ``--trace 1``
the replica's profiler then covers a replay, after the window, of the
requests due in its first ``trace_seconds``, sent at the same offsets
through the same handle; the device metrics read that.
"""

from __future__ import annotations

import gc
import math
import queue
import statistics
import threading
import time

import numpy as np

from bench_port import check, inputs, reference, system
from bench_port.trace import ThreadTracer
from bench_port.weights import stream_seed


def schedule(traffic: dict, seed: int, seconds: float):
    """(due offsets s [n], prompt lengths [n]) of the window."""
    n = max(1, round(traffic["rate_per_s"] * seconds))
    rng = np.random.default_rng(stream_seed(seed, "schedule"))
    due = np.sort(rng.uniform(0.0, seconds, n))
    normal = statistics.NormalDist()
    lengths = np.exp(math.log(traffic["length_median"]) + traffic[
        "length_sigma"] * np.array([normal.inv_cdf((k + 0.5) / n)
                                    for k in range(n)]))
    lengths = np.clip(np.rint(lengths), traffic["length_min"],
                      traffic["length_max"]).astype(np.int64)
    return due, rng.permutation(lengths)


def prompts(conf: dict, lengths, seed: int) -> list:
    rng = np.random.default_rng(stream_seed(seed, "prompts"))
    return [rng.integers(0, conf["vocab_size"], size=int(n), dtype=np.int64)
            for n in lengths]


def padded(length: int, multiple: int) -> int:
    return -(-length // multiple) * multiple


def make_scorer(traffic: dict):
    """The deployment class, its batching taken from the traffic."""
    from ray_tpu_torch import serve

    class Scorer:
        def __init__(self, conf: dict, seed: int, device: str,
                     warm: list):
            import torch

            self.conf, self.device = conf, device
            self.fwd = system.family(conf).forward(conf, device)
            self.params = inputs.family(conf).make_weights(conf, seed,
                                                           device)
            self.log = []
            self.card = threading.Lock()
            for rows, length in warm:
                self._forward([{"id": -1, "tokens": np.zeros(length,
                                                             np.int64)}]
                              * rows)
            self.log.clear()
            if device == "cuda":
                torch.cuda.synchronize()

        def _forward(self, requests: list) -> list:
            import torch
            from torch.profiler import record_function

            lengths = [len(r["tokens"]) for r in requests]
            width = padded(max(lengths), traffic["pad_multiple"])
            tokens = np.zeros((len(requests), width), np.int64)
            for row, r in enumerate(requests):
                tokens[row, :len(r["tokens"])] = r["tokens"]
            with self.card:
                start = time.monotonic()
                with record_function("bench.forward"):
                    logits = self.fwd(self.params, tokens)
                    last = logits[torch.arange(len(requests)),
                                  torch.as_tensor(lengths) - 1].cpu().numpy()
                del logits
                end = time.monotonic()
                self.log.append({"start": start, "end": end,
                                 "ids": [r["id"] for r in requests],
                                 "width": width})
            return [{"id": r["id"], "logits": row}
                    for r, row in zip(requests, last)]

        @serve.batch(max_batch_size=traffic["max_batch_size"],
                     batch_wait_timeout_s=traffic["batch_wait_timeout_s"])
        def __call__(self, requests: list) -> list:
            return self._forward(requests)

        def batches(self) -> list:
            return list(self.log)

        def start_trace(self) -> None:
            """With --trace 1, after the window: the profiler from here
            until ``stop_trace``. Its first start initialises CUPTI for
            seconds, so a throwaway start and stop pays that first."""
            with self.card:
                warm = ThreadTracer(self.device)
                warm.start()
                warm.stop()
                self.tracer = ThreadTracer(self.device)
                self.launches0 = system.attention_counts()
                self.trace_from = len(self.log)
                self.tracer.start()

        def stop_trace(self) -> dict:
            """The traced stretch: its summary, batches and launches."""
            with self.card:
                self.tracer.stop()
                launches = {k: v - self.launches0[k]
                            for k, v in system.attention_counts().items()}
                return {"summary": self.tracer.summary(),
                        "batches": self.log[self.trace_from:],
                        "launches": launches}

    return Scorer


def warm_shapes(traffic: dict, lengths) -> list:
    """(rows, length) to warm: the widest batch the traffic can form,
    then one row at every padded width it can reach."""
    widths = sorted({padded(int(n), traffic["pad_multiple"])
                     for n in lengths})
    return [(traffic["max_batch_size"], widths[-1])] + [(1, w)
                                                        for w in widths]


def _send_and_collect(handle, requests, due_at, drain_until):
    """Open loop: request i is sent at due_at[i]; -> (sent, done,
    answers, errors) by request."""
    import ray_tpu_torch

    n = len(requests)
    sent, done = [None] * n, [None] * n
    answers, errors = [None] * n, [None] * n
    refs: "queue.Queue" = queue.Queue()

    def sender():
        for i, req in enumerate(requests):
            delay = due_at[i] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            sent[i] = time.monotonic()
            try:
                refs.put((i, handle.remote(req)))
            except Exception as exc:  # counted as failed below
                errors[i] = repr(exc)
                refs.put((i, None))

    thread = threading.Thread(target=sender, daemon=True)
    thread.start()
    pending = {}
    finished = 0
    while finished < n and time.monotonic() < drain_until:
        while True:
            try:
                i, ref = refs.get_nowait()
            except queue.Empty:
                break
            if ref is None:
                finished += 1
            else:
                pending[ref] = i
        if not pending:
            time.sleep(0.001)
            continue
        ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1,
                                      timeout=0.02)
        for ref in ready:
            i = pending.pop(ref)
            done[i] = time.monotonic()
            try:
                answers[i] = ray_tpu_torch.get(ref)
            except Exception as exc:
                errors[i] = repr(exc)
                done[i] = None
            finished += 1
    thread.join(timeout=max(0.0, drain_until - time.monotonic()) + 1)
    return sent, done, answers, errors


def run(cell: dict, device: str) -> dict:
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster

    conf, traffic, seed = cell["conf"], cell["traffic"], cell["seed"]
    seconds = cell["seconds"]
    due, lengths = schedule(traffic, seed, seconds)
    texts = prompts(conf, lengths, seed)
    requests = [{"id": i, "tokens": t} for i, t in enumerate(texts)]
    cluster = Cluster(head_node_args={
        "num_cpus": 4, "num_gpus": 1, "device": device,
        "_system_config": {"object_store_memory": 4 << 30}})
    try:
        serve.start()
        try:
            deployment = serve.deployment(
                name="Scorer", num_replicas=1,
                ray_actor_options={"num_gpus": 1},
                max_concurrent_queries=traffic["max_concurrent_queries"],
            )(make_scorer(traffic))
            deployment.deploy(conf, seed, device,
                              warm_shapes(traffic, lengths))
            handle = deployment.get_handle()
            ray_tpu_torch.get(handle.remote(
                {"id": -1, "tokens": texts[int(np.argmax(lengths))]}))
            ray_tpu_torch.get(handle.batches.remote())
            t0 = time.monotonic()
            sent, done, answers, errors = _send_and_collect(
                handle, requests, t0 + due,
                t0 + seconds + traffic["drain_s"])
            batches = [b for b in ray_tpu_torch.get(handle.batches.remote())
                       if b["ids"] != [-1]]
            traced = {}
            if cell["trace"]:
                replay = int(np.searchsorted(due, traffic["trace_seconds"]))
                ray_tpu_torch.get(handle.start_trace.remote())
                r0 = time.monotonic()
                _send_and_collect(handle, requests[:replay], r0 + due[:replay],
                                  r0 + traffic["trace_seconds"]
                                  + traffic["drain_s"])
                traced = ray_tpu_torch.get(handle.stop_trace.remote())
        finally:
            serve.shutdown()
    finally:
        cluster.shutdown()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    del deployment, handle
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    finished = [i for i in range(len(requests)) if answers[i] is not None]
    numbers = None
    if finished and traffic["check_sample"]:
        numbers = _compare(conf, seed, texts, answers, finished,
                           traffic["check_sample"], device)
    failed = len(requests) - len(finished)
    wrong_ids = [i for i in finished if answers[i]["id"] != i]
    latency = [(done[i] - (t0 + due[i])) * 1e3 if answers[i] is not None
               else traffic["drain_s"] * 1e3 + seconds * 1e3
               for i in range(len(requests))]
    traced_batches = traced.get("batches", [])
    record = {
        "t0": t0, "due": (t0 + due).tolist(), "sent": sent, "done": done,
        "latency_ms": latency, "lengths": lengths.tolist(),
        "batches": batches,
        "useful_flops": [inputs.family(conf).score_flops(conf, int(n))
                         for n in lengths],
        "trace": traced.get("summary"),
        "trace_launches": traced.get("launches"),
        "attention_calls": [system.family(conf).score_attention_calls(
            conf, len(b["ids"]), b["width"]) for b in traced_batches],
    }
    if numbers is not None:
        numbers["misrouted"] = {"value": float(len(wrong_ids))}
    late = [(s - d) * 1e3 for s, d in zip(sent, record["due"])
            if s is not None]
    return {
        "window_start": t0,
        "generator_late_ms": {"median": float(np.median(late)),
                              "max": float(max(late))},
        "end_to_end": {"serve_p50_ms": float(np.percentile(latency, 50)),
                       "serve_p95_ms": float(np.percentile(latency, 95))},
        "record": record, "numbers": numbers or {},
        "attempted": len(requests), "failed": failed,
        "errors": [e for e in errors if e][:3],
        "memory_peak_bytes": peak,
    }


def _compare(conf, seed, texts, answers, finished, sample, device) -> dict:
    import torch

    rng = np.random.default_rng(stream_seed(seed, "check_sample"))
    longest = max(finished, key=lambda i: len(texts[i]))
    rest = [i for i in finished if i != longest]
    picks = [longest] + sorted(rng.choice(rest, size=min(sample - 1,
                                                         len(rest)),
                                          replace=False).tolist())
    weights = inputs.family(conf).make_weights(conf, seed, device)
    ref = reference.family(conf).score_last(
        conf, weights, [torch.as_tensor(texts[i]) for i in picks])
    del weights
    served = torch.as_tensor(np.stack([answers[i]["logits"]
                                       for i in picks]), device=ref.device)
    return check.score_numbers(served, ref)
