"""Weights and inputs made from the run's seed, on the run's device.

Each leaf and each batch has a generator of its own, seeded from the
run's seed and its name, so that the reference can make any one of them
again, alone and in the same numbers, after the program's state is
gone. A leaf is one ``torch.randn`` call in the type it is served in.
"""

from __future__ import annotations

import hashlib

import torch


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name))


def normal_leaf(seed: int, name: str, shape, std: float, dtype,
                device) -> torch.Tensor:
    out = torch.randn(shape, generator=generator(seed, name, device),
                      device=device, dtype=dtype)
    return out.mul_(std)


def make_tree(specs, seed: int, device) -> dict:
    """The nested dict of leaves that ``specs`` lists: (path, shape,
    std, dtype), with std ``"ones"`` or ``"zeros"`` for a constant."""
    tree: dict = {}
    for path, shape, std, dtype in specs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if std == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        elif std == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        else:
            leaf = normal_leaf(seed, "/".join(path), shape, std, dtype,
                               device)
        node[path[-1]] = leaf
    return tree
