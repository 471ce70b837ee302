"""The system under test: how the benchmark drives ``ray_tpu_torch``'s
entry points for each model family a configuration file names. These
modules import the port; nothing else of the harness's yardstick does."""

from __future__ import annotations

import importlib


def family(conf: dict):
    """The system module of ``conf``'s family."""
    return importlib.import_module(f"bench_port.system.{conf['family']}")


def attention_counts() -> dict:
    """The port's launch counters of K1 (fwd), K2 (dq) and K3 (dkdv)."""
    from ray_tpu_torch.ops import attention

    return {"fwd": attention.launches.count,
            "dq": attention.dq_launches.count,
            "dkdv": attention.dkdv_launches.count}

