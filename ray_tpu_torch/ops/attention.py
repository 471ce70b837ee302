"""Flash attention forward: a hand-written Hopper kernel and its plain
torch versions.

Port of the forward half of ``ray_tpu/ops/attention.py``:

  flash_attention(q, k, v, causal=True, sm_scale=None) -> (out, lse)
    -> CUDA tensors: the kernel in csrc/flash_attn_fwd.cu (the port of
       the TPU kernel ``_flash_kernel``), built with nvcc at first use;
    -> CPU tensors: ``_blockwise_fwd``, the plain blockwise version.

There is no fallback between the two: a CUDA tensor the kernel does not
take (dtype, head dim, layout) raises. The backward kernels wait for
the training slice.

Layouts: q/k/v [batch, seq, heads, head_dim]; ``out`` in q's dtype with
q's layout; ``lse`` [batch, heads, seq_q] float32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

BLOCKWISE_BLOCK_K = 128
_NEG_INF = -1e30

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("flash_attn_fwd.cu",)
# kernel builds land here (listed in .gitignore), keyed by source digest
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ===========================================================================
# Plain versions (the CPU path, and the kernel's yardstick on the card).
# ===========================================================================


def attention_reference(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """O(S^2)-memory reference implementation for tests."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _blockwise_fwd(q, k, v, causal: bool, sm_scale: float,
                   block_k: int = BLOCKWISE_BLOCK_K
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online softmax over K/V blocks in fp32; returns (out, lse).

    The JAX package's blockwise scan, as a Python loop. A ragged last
    block is sliced short instead of zero-padded: padded keys contribute
    exp(-1e30 - m) = 0 there, so the two are the same computation."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf = q.float()
    q_pos = torch.arange(sq, device=q.device)
    acc = torch.zeros_like(qf)
    m_run = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, sk, block_k):
        k_blk = k[:, start:start + block_k].float()
        v_blk = v[:, start:start + block_k].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk) * sm_scale
        if causal:
            k_pos = start + torch.arange(k_blk.shape[1], device=q.device)
            valid = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(valid[None, None], logits, _NEG_INF)
        m_new = torch.maximum(m_run, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(dim=-1)
        acc = (acc * alpha.transpose(1, 2)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p, v_blk))
        m_run = m_new
    l_safe = torch.clamp(l_run, min=1e-20)
    out = acc / l_safe.transpose(1, 2)[..., None]
    lse = m_run + torch.log(l_safe)  # [B, H, Sq]
    return out.to(q.dtype), lse


# ===========================================================================
# The Hopper kernel: build, bind, launch.
# ===========================================================================


class LaunchCount:
    """Launches of one kernel, counted by its wrapper where it launches
    and nowhere else (a run reads it to show the kernel served it)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


launches = LaunchCount()
_lib = None
_build_log = ""
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_kernels() -> str:
    """Compile csrc/ with nvcc into BUILD_DIR (once per source digest)
    and load it; returns the compiler's resource report. Called at the
    first kernel launch, or ahead of it by a caller that wants the build
    outside its timings."""
    global _lib, _build_log
    with _lib_lock:
        if _lib is not None:
            return _build_log
        sources = [_CSRC / name for name in _SOURCES]
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in sources)
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"librtt_kernels_{digest}.so"
        log = BUILD_DIR / f"librtt_kernels_{digest}.log"
        if not so.exists():
            tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(p) for p in sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.rtt_flash_attn_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _build_log = log.read_text() if log.exists() else ""
        _lib = lib
        return _build_log


def _check_kernel_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects [B, S, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"k/v must be [B, Sk, H, D] matching q {tuple(q.shape)}; got "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(
            f"the CUDA flash_attention kernel takes bfloat16 or float32 "
            f"q/k/v of one dtype; got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash_attention kernel takes head_dim in "
            f"{_HEAD_DIMS}; got {d}")
    if q.shape[1] == 0 or k.shape[1] == 0 or b == 0 or h == 0:
        raise ValueError("flash_attention needs non-empty q and k/v")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"the CUDA flash_attention kernel takes contiguous, "
                f"16-byte aligned {name}")


def _kernel_fwd(q, k, v, causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs(q, k, v)
    if _lib is None:
        build_kernels()
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib.rtt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d, int(bool(causal)),
            float(sm_scale), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err} "
            f"(q {tuple(q.shape)} {q.dtype}, sk {sk}, causal {causal})")
    launches.add()
    return out, lse


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward -> (out [B,Sq,H,D] in q's dtype, lse [B,H,Sq]
    float32). CUDA tensors launch the kernel (or raise); CPU tensors take
    the plain blockwise path."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _kernel_fwd(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return _blockwise_fwd(q, k, v, causal, scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
