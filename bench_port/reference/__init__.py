"""Plain PyTorch references, in float32 with TF32 off.

They import nothing of the program and take nothing it made: the
weights and batches come from ``bench_port.inputs`` (made again from the
run's seed) and the program's outputs are read only to be judged. Every
matrix product goes through one function, ``mm``: ``"fp32"`` is the
reference, ``"fp8"`` rounds both operands to float8 e4m3 with one scale
a tensor (the precision below the configurations' bfloat16) and is the
control that a sound comparison must fail.
"""

from __future__ import annotations

import contextlib

import torch


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale (amax to 448), back in
    t's type; the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach()) if t.requires_grad else q


def _mm_fp8(a, b):
    return torch.matmul(fp8_round(a), fp8_round(b))


MATMUL = {"fp32": torch.matmul, "fp8": _mm_fp8}


@contextlib.contextmanager
def float32_exact():
    """float32 products in float32 (no TF32) for the block's duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def family(conf: dict):
    import importlib

    return importlib.import_module(f"bench_port.reference.{conf['family']}")
