"""How ``correct`` is decided: the program's outputs against the plain
reference's, as numbers each held to a limit of its own.

Training (the first three steps of the object the window then drives):
  loss_gap     the largest relative gap of a step's loss;
  grad1_gap    the worst leaf's gap between the norms of the first
               gradient as the optimizer got it (the program's read back
               from its first moment after one step);
  change_gap   the worst leaf's gap between the norms of the parameters'
               change after the third step;
  grad1_median_gap, change_median_gap
               the median leaf's gap of the same norms.
A leaf's gap is |program's norm - reference's norm| over the larger of
the reference's norm of that leaf and of the median leaf. Leaves whose
reference first gradient is under a thousandth of the median leaf's move
under Adam by round-off alone and are left out of change_gap.

Scoring (a sample of the finished requests, drawn from the seed, with
the longest among them):
  logits_rel   the worst request's relative L2 gap of its served logits;
  top1_gap     the widest gap by which the reference's logit of the
               served top token lies below the reference's best.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

ROUND_OFF_SHARE = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms."""
    names = list(ref if names is None else names)
    median = statistics.median(ref[n] for n in ref)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
            for n in names}


def _worst_and_median(gaps: Dict[str, float], name: str) -> Dict[str, dict]:
    worst = max(gaps, key=gaps.get)
    return {f"{name}_gap": {"value": gaps[worst], "at": worst},
            f"{name}_median_gap": {"value": statistics.median(
                gaps.values())}}


def moving_leaves(ref_grad1: Dict[str, float]) -> List[str]:
    median = statistics.median(ref_grad1.values())
    return [n for n, g in ref_grad1.items() if g >= ROUND_OFF_SHARE * median]


def train_numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                   ref["loss"]))
    return {"loss_gap": {"value": loss},
            **_worst_and_median(leaf_gaps(prog["grad1"], ref["grad1"]),
                                "grad1"),
            **_worst_and_median(leaf_gaps(prog["change"], ref["change"],
                                          moving_leaves(ref["grad1"])),
                                "change")}


def score_numbers(served, ref) -> Dict[str, dict]:
    """``served`` and ``ref``: [n, vocab] float tensors, row for row."""
    import torch

    served, ref = served.double(), ref.double()
    rel = (served - ref).norm(dim=1) / ref.norm(dim=1)
    top = ref.max(dim=1).values - ref.gather(
        1, served.argmax(dim=1, keepdim=True))[:, 0]
    return {"logits_rel": {"value": rel.max().item(),
                           "at": int(torch.argmax(rel))},
            "top1_gap": {"value": top.max().item(),
                         "at": int(torch.argmax(top))}}
