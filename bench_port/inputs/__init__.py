"""What the benchmark hands to both sides: weights and batches made from
the run's seed, in the program's parameter layout, for each model family
a configuration file names (``"family"``). Imports nothing of the
program, so the references may use it."""

from __future__ import annotations

import importlib


def family(conf: dict):
    """The inputs module of ``conf``'s family."""
    return importlib.import_module(f"bench_port.inputs.{conf['family']}")


def flatten(tree, prefix: str = ""):
    """[(name, leaf)] of nested dicts and lists, in insertion order (the
    order of the program's ``tree_leaves``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, value in items:
        out.extend(flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return out
