"""The one place a device is resolved.

Every entry point of the package (``init``, the model constructors,
``build_forward``) takes ``device=None`` and passes it through
:func:`resolve_device`: ``None`` means CUDA, and a missing CUDA is an
error. Nothing drops to the CPU on its own; a caller that wants the CPU
(the parity tests) asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on CUDA by default and this process sees "
            "no CUDA device; pass device='cpu' to run on the CPU")
    return dev
