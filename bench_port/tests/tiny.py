"""The cells at tiny sizes, with limits for those sizes, for CPU runs of
the harness. The widths are cut (which a cell never does) so that the
port's CPU paths finish in seconds; the sound runs' and the faults'
readings at these sizes are in the tests that use them."""

from __future__ import annotations

import copy

from bench_port import run

DECODER = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=16, intermediate_size=128, vocab_size=256,
               num_hidden_layers=2, max_position_embeddings=128)
TRAFFIC = {
    "train": {"trace_from": 1, "trace_steps": 1},
    "score": {"rate_per_s": 4.0, "length_median": 24, "length_min": 8,
              "length_max": 64, "pad_multiple": 16, "drain_s": 20,
              "check_sample": 4, "trace_seconds": 1.0},
}
# limits at these sizes: sound runs read about a quarter of each or less
LIMITS = {
    "decoder-train": {"grad1_gap": {"limit": 0.01},
                      "change_gap": {"limit": 0.5}},
    "decoder-score": {"logits_rel": {"limit": 0.08},
                      "misrouted": {"limit": 0.0}},
}


def cell(workload: str) -> dict:
    out = copy.deepcopy(run.load_cell(workload))
    family = out["conf"]["family"]
    out["conf"].update(DECODER)
    kind = out["traffic"]["kind"]
    out["traffic"].update(TRAFFIC[kind])
    if kind == "train":
        out["traffic"].update(batch=2, seq=32)
    out["limits"] = LIMITS[f"{family}-{kind}"]
    return out


def execute(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 1.5,
            trace: bool = False) -> dict:
    return run.execute(cell(workload), seed, seconds, trace, "cpu")
