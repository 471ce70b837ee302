"""The general generator of training traffic (``"kind": "train"``).

Set-up: a one-GPU in-process cluster (thread-tier raylets), a
``train.Trainer(num_workers=1, use_gpu=True)``, and in its train
function one object, the family's train step with its weights and
optimizer state made from the seed. The first ``checked_steps`` steps go
through the same call and feed as the window's, on batches that all
differ, and their readings are kept; then the window drives the same
object for ``--seconds``, a new seeded batch each step, each step's loss
reported through ``train.report``. With ``--trace 1`` the profiler
covers ``trace_steps`` window steps from ``trace_from``.

After the window the program's state is freed and the family's float32
reference follows the checked steps from the same seed.
"""

from __future__ import annotations

import gc
import tempfile
import time

from bench_port import check, inputs, reference, system
from bench_port.trace import Tracer
from bench_port.weights import make_tree


def train_loop(config: dict) -> dict:
    """The train function the Trainer runs on its worker."""
    import torch
    from torch.profiler import record_function

    from ray_tpu_torch import train

    conf, traffic, seed = config["conf"], config["traffic"], config["seed"]
    device = config["device"]
    family, sysmod = inputs.family(conf), system.family(conf)
    step, init_state, first_grads = sysmod.train_step(conf, traffic, device)
    params = family.make_weights(conf, seed, device)
    state = init_state(params)
    names = [n for n, _ in inputs.flatten(params)]
    readings = {"loss": []}
    for i in range(traffic["checked_steps"]):
        loss = step(params, state, family.make_batch(conf, traffic, seed, i,
                                                      device))
        readings["loss"].append(loss.item())
        train.report(step=i, loss=readings["loss"][-1])
        if i == 0:
            readings["grad1"] = dict(zip(
                names, (g.norm().item() for g in first_grads(state))))
    # each leaf's change, against the leaf made again from the seed
    now = dict(inputs.flatten(params))
    readings["change"] = {}
    for spec in family.weight_specs(conf):
        name, start = inputs.flatten(make_tree([spec], seed, device))[0]
        readings["change"][name] = (now[name].detach().float()
                                    - start.float()).norm().item()
        del start
    del now
    if device == "cuda":
        torch.cuda.synchronize()
    tracer = Tracer(device)
    first = traffic["trace_from"]
    last = first + traffic["trace_steps"]
    steps, i = [], traffic["checked_steps"]
    t0 = time.monotonic()
    while True:
        n = len(steps)
        if config["trace"] and n == first:
            launches0 = system.attention_counts()
            tracer.start()
        begin = time.monotonic()
        with record_function("bench.feed"):
            batch = family.make_batch(conf, traffic, seed, i, device)
        call0 = time.monotonic()
        with record_function("bench.step"):
            loss = step(params, state, batch).item()
        call1 = time.monotonic()
        with record_function("bench.report"):
            train.report(step=i, loss=loss)
        end = time.monotonic()
        steps.append({"begin": begin, "call0": call0, "call1": call1,
                      "end": end, "traced": config["trace"]
                      and first <= n < last})
        i += 1
        if config["trace"] and n + 1 == last:
            tracer.stop()
            launches = {k: v - launches0[k]
                        for k, v in system.attention_counts().items()}
        if end - t0 >= config["seconds"] and (
                not config["trace"] or n + 1 >= last):
            break
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    out = {"t0": t0, "steps": steps, "readings": readings,
           "memory_peak_bytes": peak}
    if config["trace"]:
        out["trace"] = tracer.summary()
        out["trace_launches"] = launches
    return out


def run(cell: dict, device: str) -> dict:
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.cluster_utils import Cluster

    conf, traffic = cell["conf"], cell["traffic"]
    config = {"conf": conf, "traffic": traffic, "seed": cell["seed"],
              "seconds": cell["seconds"], "trace": cell["trace"],
              "device": device}
    with tempfile.TemporaryDirectory(prefix="bench_port_train_") as logdir:
        cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 1,
                                          "device": device})
        try:
            trainer = train.Trainer(num_workers=1, use_gpu=True,
                                    logdir=logdir)
            try:
                out = trainer.run(train_loop, config=config)[0]
            finally:
                trainer.shutdown()
        finally:
            cluster.shutdown()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = reference.family(conf).train_readings(
        conf, traffic, cell["seed"], traffic["checked_steps"], device)
    numbers = check.train_numbers(out["readings"], ref)

    steps = out["steps"]
    window_s = steps[-1]["end"] - out["t0"]
    family = inputs.family(conf)
    tokens = family.tokens_per_step(conf, traffic)
    record = {"steps": steps, "tokens_per_step": tokens,
              "flops_per_step": family.train_flops(conf, traffic),
              "attention_calls": system.family(conf).train_attention_calls(
                  conf, traffic),
              "trace": out.get("trace"),
              "trace_launches": out.get("trace_launches")}
    return {
        "window_start": out["t0"],
        "end_to_end": {"train_tokens_per_s": tokens * len(steps) / window_s},
        "record": record, "numbers": numbers,
        "attempted": len(steps), "failed": 0,
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
