"""The readings a cell's limits are set from (``bench_port/limits/``).

    python3 -m bench_port.calibrate --workload <name> --seeds a,b,...
        [--controls a,b,c] [--seconds s] [--rate r]

Lower readings: the cell's driver run on each seed in one process, with
a short window at the cell's own load (training: the checked steps need
none), each line the numbers its check compared. Upper readings, on the
``--controls`` seeds at the cell's own size: the control, the float32
reference computed with every matrix product's operands rounded to
float8 e4m3 (the precision below the configurations' bfloat16), put in
the program's place; and the faults a cell can have, planted in the
reference put in the program's place: for training, half of each batch
left out with the mean over the rest (a state left unchanged reads 1 by
``change_gap`` and needs no run); for scoring, an answer taken at the
wrong position (the last but one). Prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def lower(cell: dict, seeds: list, seconds: float, device: str) -> None:
    import torch

    from bench_port.drivers import score, train

    driver = train if cell["traffic"]["kind"] == "train" else score
    for seed in seeds:
        out = driver.run({**cell, "seed": seed, "seconds": seconds,
                          "trace": False}, device)
        print(json.dumps({"reading": "program", "seed": seed,
                          "numbers": out["numbers"],
                          "failed": out["failed"],
                          "end_to_end": out["end_to_end"]}), flush=True)
        del out
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


def upper_train(cell: dict, seeds: list, device: str) -> None:
    from bench_port import check, reference

    conf, traffic = cell["conf"], cell["traffic"]
    ref_mod = reference.family(conf)
    steps = traffic["checked_steps"]
    half = traffic["batch"] // 2
    for seed in seeds:
        ref = ref_mod.train_readings(conf, traffic, seed, steps, device)
        for name, kw in (("control_fp8", {"precision": "fp8"}),
                         ("fault_half_batch",
                          {"batch_rows": slice(0, half)})):
            got = ref_mod.train_readings(conf, traffic, seed, steps, device,
                                         **kw)
            print(json.dumps({"reading": name, "seed": seed,
                              "numbers": check.train_numbers(got, ref)}),
                  flush=True)
            del got


def upper_score(cell: dict, seeds: list, device: str) -> None:
    import numpy as np
    import torch

    from bench_port import check, inputs, reference
    from bench_port.drivers import score
    from bench_port.weights import stream_seed

    conf, traffic = cell["conf"], cell["traffic"]
    ref_mod = reference.family(conf)
    for seed in seeds:
        _, lengths = score.schedule(traffic, seed, cell["seconds"])
        texts = score.prompts(conf, lengths, seed)
        rng = np.random.default_rng(stream_seed(seed, "check_sample"))
        longest = int(np.argmax(lengths))
        rest = [i for i in range(len(texts)) if i != longest]
        picks = [longest] + sorted(rng.choice(
            rest, size=traffic["check_sample"] - 1, replace=False).tolist())
        weights = inputs.family(conf).make_weights(conf, seed, device)
        prompts = [torch.as_tensor(texts[i]) for i in picks]
        ref = ref_mod.score_last(conf, weights, prompts)
        fp8 = ref_mod.score_last(conf, weights, prompts, precision="fp8")
        shifted = ref_mod.score_last(conf, weights, [p[:-1] for p in prompts])
        for name, got in (("control_fp8", fp8),
                          ("fault_wrong_position", shifted)):
            print(json.dumps({"reading": name, "seed": seed,
                              "numbers": check.score_numbers(got, ref)}),
                  flush=True)
        del weights, ref, fp8, shifted


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--controls", default="")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--rate", type=float, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from bench_port import run

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    if args.rate is not None:
        cell["traffic"]["rate_per_s"] = args.rate
    lower(cell, _seeds(args.seeds), args.seconds, args.device)
    controls = _seeds(args.controls)
    if controls and cell["traffic"]["kind"] == "train":
        upper_train(cell, controls, args.device)
    elif controls:
        upper_score({**cell, "seconds": args.seconds}, controls,
                    args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
