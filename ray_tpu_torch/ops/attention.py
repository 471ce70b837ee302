"""Flash attention: hand-written Hopper kernels and their plain torch
versions.

Port of ``ray_tpu/ops/attention.py``:

  flash_attention(q, k, v, causal=True, sm_scale=None) -> out
    a differentiable op (``_FlashAttention``, the JAX package's
    ``custom_vjp``); it saves (q, k, v, out, lse) and its backward
    recomputes p from lse, so the [S, S] matrix never materializes;
    -> CUDA tensors: the kernels in csrc/, built with nvcc at first use:
       K1 ``flash_attn_fwd.cu`` (port of the TPU kernel ``_flash_kernel``)
       for the forward, K2 and K3 ``flash_attn_bwd.cu`` (ports of
       ``_bwd_dq_kernel`` and ``_bwd_dkdv_kernel``) for the backward;
       ``kernel_route`` names the kernel each (dtype, head dim) takes;
    -> CPU tensors: ``_blockwise_fwd`` / ``_blockwise_bwd``, the plain
       blockwise versions.
  _fwd_dispatch(q, k, v, causal, sm_scale) -> (out, lse), the forward
    alone (no autograd), as in the JAX package.

There is no fallback between the two: a CUDA tensor the kernels do not
take (dtype, head dim, layout) raises. Every head dim and dtype the
forward takes, the backward takes too: the JAX package's rule that sends
head_dim % 128 != 0 to the blockwise backward is a TPU lane rule.

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
from typing import Callable, Optional, Tuple

import torch

BLOCKWISE_BLOCK_K = 128
_NEG_INF = -1e30

_CSRC = Path(__file__).resolve().parent / "csrc"
# one nvcc per source, all started together, then one link: the padded
# wgmma routes are instantiated at every padded head dim up to 256, the
# fp32 ring kernels (a source each for K1, K2 and K3) at each one-slice
# width; past it the wgmma and ring kernels at each slice width; each
# kernel's wgmma template once for each feed (TMA, cp.async), past 256
# the backward's once for K2 and once for K3, so that the halves of
# their instantiations compile side by side
_SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu",
            "flash_attn_fwd_padded.cu", "flash_attn_fwd_padded_cp_async.cu",
            "flash_attn_bwd_dq_padded.cu",
            "flash_attn_bwd_dq_padded_cp_async.cu",
            "flash_attn_bwd_dkdv_padded.cu",
            "flash_attn_bwd_dkdv_padded_cp_async.cu",
            "flash_attn_fwd_fma_ring.cu", "flash_attn_bwd_dq_fma_ring.cu",
            "flash_attn_bwd_dkdv_fma_ring.cu",
            "flash_attn_dchunk_fma.cu", "flash_attn_dchunk_fwd_wgmma.cu",
            "flash_attn_dchunk_fwd_cp_async.cu",
            "flash_attn_dchunk_bwd_dq_wgmma.cu",
            "flash_attn_dchunk_bwd_dkdv_wgmma.cu",
            "flash_attn_dchunk_bwd_dq_cp_async.cu",
            "flash_attn_dchunk_bwd_dkdv_cp_async.cu",
            "flash_attn_dchunk_bwd_dq_fma.cu",
            "flash_attn_dchunk_bwd_dkdv_fma.cu")
_HEADERS = ("flash_attn_common.cuh", "flash_attn_routes.cuh",
            "flash_attn_bwd_dq_ws.cuh", "flash_attn_bwd_dkdv_padded.cuh",
            "flash_attn_fwd_padded.cuh", "flash_attn_dchunk_fwd_wgmma.cuh",
            "flash_attn_dchunk_bwd_wgmma.cuh",
            "flash_attn_ring_f32.cuh", "hopper_common.cuh")
# kernel builds land here (listed in .gitignore), keyed by source digest
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# the widest head dim of the per-head-dim routes; past it the 64-row tile
# rings and fp32 slabs of a block do not fit the H100's 227 KB of shared
# memory at full width, and the chunked route takes over
DCHUNK_PAST = 256
_WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel each launch takes, as the C launchers dispatch it (the
# names of the wgmma routes say what fills their shared-memory boxes:
# TMA, which needs a row stride of a multiple of 16 bytes, head_dim % 8
# == 0 in bf16; or cp.async, by the producer warpgroups' threads, 8 or 4
# bytes a copy by the row's alignment and at odd head_dim 2-byte loads
# through registers, into the same 128-byte-swizzled boxes). In bf16 a
# head dim takes the same route for K1, K2 and K3:
#   WGMMA: bf16 at head_dim 64 and 128 -- wgmma on TMA-fed shared-memory
#          rings, a producer warpgroup and two consumer warpgroups;
#   WGMMA_PADDED: bf16 at head_dim % 8 == 0 up to 256 but 64 and 128
#          (those under 64 in one 64-column box that TMA fills with zeros
#          past it) -- wgmma on TMA-fed rings as WGMMA, instantiated at
#          the head dim rounded up to 32 over rows padded with zeros to
#          64-column boxes; K2 is WGMMA's kernel at that width, K1 that
#          design with the forward's loop body (key tiles as wide as
#          shared memory allows beside resident Q: 128, 96 or 64 keys),
#          both on 64-row q tiles where 128-row ones would leave SMs idle;
#          K3 a kernel of its own (64 keys a block, the two consumer
#          warpgroups splitting each query tile's rows, then the head
#          dim's columns, or at head_dim <= 64 the two products). A name
#          of its own, so that the launch counts show which of the two
#          designs and which widths a path ran;
#   WGMMA_PADDED_CP: bf16 at head_dim % 8 != 0 up to 256 -- the
#          WGMMA_PADDED kernels with their boxes filled by cp.async
#          (csrc/flash_attn_fwd_padded.cuh, flash_attn_bwd_dq_ws.cuh,
#          flash_attn_bwd_dkdv_padded.cuh);
#   FMA_RING: float32 K1, K2 and K3 at every head_dim up to 256 --
#          exact FMAs on the CUDA cores, register-blocked (8 x 4 or 4 x 4
#          a thread) and fed by a cp.async ring, one block per 64 or 32
#          rows and all of the head dim (rounded up to 16, 32 or 64
#          under 64, to 64 past), its own rows (K1: Q; K2: Q and dO; K3:
#          K and V) resident (csrc/flash_attn_ring_f32.cuh);
#   Past 256, with no upper bound, where a block cannot hold full-width
#   tiles beside its rings (the Hopper designs have names of their own,
#   as WGMMA_PADDED has):
#   DCHUNK_WGMMA: bf16 at head_dim % 8 == 0 -- a block per (tile, slice
#          of the output's columns: up to 256 for K1's out and K2's dq,
#          128 for K3's dk and dv), S = Q K^T (and for K2/K3 dP = dO V^T)
#          on wgmma over the whole head dim in 64-column TMA boxes (the
#          block's own rows resident, or streamed past what fits), so S is
#          computed ceil(D / W) times a tile pair
#          (csrc/flash_attn_dchunk_fwd_wgmma.cuh,
#          csrc/flash_attn_dchunk_bwd_wgmma.cuh);
#   DCHUNK_WGMMA_CP: bf16 at head_dim % 8 != 0 -- the DCHUNK_WGMMA
#          kernels with their boxes filled by cp.async;
#   DCHUNK_FMA: float32 -- a block per (tile, slice of up to 320 output
#          columns: S and dP computed once up to D 320) on FMA_RING's
#          kernels with the block's rows streamed beside each step
#          (csrc/flash_attn_dchunk_fma.cu, flash_attn_ring_f32.cuh).
# No route runs mma.sync.
WGMMA = "wgmma_tma_ws"
WGMMA_PADDED = "wgmma_tma_ws_padded"
WGMMA_PADDED_CP = "wgmma_cp_async_ws_padded"
FMA_RING = "fma_f32_ring"
DCHUNK_WGMMA = "dchunk_wgmma_tma_ws"
DCHUNK_WGMMA_CP = "dchunk_wgmma_cp_async_ws"
DCHUNK_FMA = "dchunk_fma_f32_ring"
_KERNELS = ("fwd", "dq", "dkdv")
# the flat lse/delta rows K3's tensor map walks are indexed in int32
_MAX_ROWS = 2**31 - 1
# a C launcher returns this + cuTensorMapEncodeTiled's CUresult when it
# cannot make a tensor map (TENSOR_MAP_ERROR in csrc/hopper_common.cuh)
_TENSOR_MAP_ERROR = 1000


def kernel_route(kernel: str, dtype: torch.dtype, head_dim: int) -> str:
    """The hand-written kernel that serves ``kernel`` ("fwd", "dq" or
    "dkdv") for q/k/v of ``dtype`` and ``head_dim`` on the card; raises
    for what no kernel takes."""
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {_KERNELS}; got {kernel!r}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA flash_attention kernels take bfloat16 or "
                        f"float32; got {dtype}")
    if head_dim < 1:
        raise ValueError(f"head_dim must be at least 1; got {head_dim}")
    if head_dim > DCHUNK_PAST:
        if dtype == torch.float32:
            return DCHUNK_FMA
        return DCHUNK_WGMMA if head_dim % 8 == 0 else DCHUNK_WGMMA_CP
    if dtype == torch.float32:
        return FMA_RING
    if head_dim in _WGMMA_HEAD_DIMS:
        return WGMMA
    return WGMMA_PADDED if wgmma_padded_head_dim(head_dim) else WGMMA_PADDED_CP


def wgmma_padded_head_dim(head_dim: int) -> bool:
    """The bf16 head dims K1, K2 and K3 take on WGMMA_PADDED
    (``rtt::wgmma_padded_head_dim`` in csrc/flash_attn_routes.cuh)."""
    return (head_dim % 8 == 0 and 1 <= head_dim <= DCHUNK_PAST
            and head_dim not in _WGMMA_HEAD_DIMS)


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


def _blockwise_bwd(q, k, v, out, lse, dout, causal: bool, sm_scale: float,
                   block_k: int = BLOCKWISE_BLOCK_K
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq/dk/dv from the saved lse, one K/V block at a time, in fp32.

    The JAX package's blockwise backward: p is recomputed from lse, delta
    = rowsum(out * dout), and each block's dk/dv rows are written once
    (a ragged last block is sliced short, as in the forward)."""
    sk = k.shape[1]
    qf, of, dof = (x.float() for x in (q, out, dout))
    delta = torch.einsum("bqhd,bqhd->bhq", of, dof)  # [B, H, Sq]
    q_pos = torch.arange(q.shape[1], device=q.device)
    dq = torch.zeros_like(qf)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for start in range(0, sk, block_k):
        k_blk = k[:, start:start + block_k].float()
        v_blk = v[:, start:start + block_k].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk) * sm_scale
        p = torch.exp(logits - lse[..., None])
        if causal:
            k_pos = start + torch.arange(k_blk.shape[1], device=q.device)
            valid = q_pos[:, None] >= k_pos[None, :]
            p = torch.where(valid[None, None], p, 0.0)
        dv[:, start:start + block_k] = torch.einsum("bhqk,bqhd->bkhd", p,
                                                    dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, v_blk)
        ds = p * (dp - delta[..., None]) * sm_scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, k_blk)
        dk[:, start:start + block_k] = torch.einsum("bhqk,bqhd->bkhd", ds,
                                                    qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ===========================================================================
# The Hopper kernel: build, bind, launch.
# ===========================================================================


class LaunchCount:
    """Launches of one kernel, counted by its wrapper where it launches
    and nowhere else (a run reads it to show the kernel served it), in
    all and by the route (``kernel_route``) each launch took."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._by_route: dict = {}

    def add(self, route: str) -> None:
        with self._lock:
            self._n += 1
            self._by_route[route] = self._by_route.get(route, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._by_route = {}

    @property
    def count(self) -> int:
        return self._n

    @property
    def by_route(self) -> dict:
        with self._lock:
            return dict(self._by_route)


launches = LaunchCount()        # K1, the forward
dq_launches = LaunchCount()     # K2
dkdv_launches = LaunchCount()   # K3
_lib = None
_build_log = ""
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _run_all(cmds: list) -> list:
    """Start every command at once; wait for all -> their results."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return outs


def _compile(sources: list, so: Path, log: Path, digest: str) -> None:
    """One ``nvcc -c`` per source, all started together, then one link
    into ``so``; the compilers' reports (``-Xptxas=-v``) go to ``log``."""
    tmp = BUILD_DIR / f".{digest}.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp / (src.stem + ".o") for src in sources]
        outs = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                          str(src)] for src, obj in zip(sources, objs)])
        part = tmp / so.name
        _run_all([[_nvcc(), _ARCH, "-shared", "-o", str(part),
                   *(str(o) for o in objs)]])
        log.write_text("".join(outs))
        os.replace(part, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
            b"".join(p.read_bytes() for p in
                     (*sources, *(_CSRC / name for name in _HEADERS)))
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"librtt_kernels_{digest}.so"
        log = BUILD_DIR / f"librtt_kernels_{digest}.log"
        if not so.exists():
            _compile(sources, so, log, digest)
        lib = ctypes.CDLL(str(so))
        fn = lib.rtt_flash_attn_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for fn, n_ptrs in ((lib.rtt_flash_attn_bwd_dq, 7),
                           (lib.rtt_flash_attn_bwd_dkdv, 8)):
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
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
    kernel_route("fwd", q.dtype, d)  # raises for a head_dim none takes
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
    _launch_check(err, "fwd", q, sk, causal)
    launches.add(kernel_route("fwd", q.dtype, d))
    return out, lse


def _check_like(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype \
            or t.device != like.device:
        raise ValueError(
            f"{name} must match q: {tuple(like.shape)} {like.dtype} on "
            f"{like.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"the CUDA flash_attention backward takes "
                         f"contiguous, 16-byte aligned {name}")


def _launch_check(err: int, kernel: str, q, sk: int, causal: bool) -> None:
    """Raises for a non-zero return of a C launcher: a cudaError_t, or
    ``_TENSOR_MAP_ERROR`` + the encoder's CUresult when a TMA tensor map
    could not be made (so the kernel never launched)."""
    if err == 0:
        return
    cause = (f"cuTensorMapEncodeTiled returned CUresult "
             f"{err - _TENSOR_MAP_ERROR}" if err >= _TENSOR_MAP_ERROR
             else f"cudaError {err}")
    raise RuntimeError(
        f"flash_attention {kernel} kernel launch failed: {cause} (route "
        f"{kernel_route(kernel, q.dtype, q.shape[-1])}, q "
        f"{tuple(q.shape)} {q.dtype}, sk {sk}, causal {causal})")


def _bwd_tail(q, k, causal: bool, sm_scale: float) -> tuple:
    b, sq, h, d = q.shape
    return (b, h, sq, k.shape[1], d, int(bool(causal)), float(sm_scale),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _kernel_bwd_dq(q, k, v, dout, lse, delta, causal: bool,
                   sm_scale: float) -> torch.Tensor:
    """K2 on the current stream, on inputs ``_kernel_bwd`` checked."""
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib.rtt_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_bwd_tail(q, k, causal, sm_scale))
    _launch_check(err, "dq", q, k.shape[1], causal)
    dq_launches.add(kernel_route("dq", q.dtype, q.shape[-1]))
    return dq


def _kernel_bwd_dkdv(q, k, v, dout, lse, delta, causal: bool,
                     sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the current stream, on inputs ``_kernel_bwd`` checked."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _lib.rtt_flash_attn_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_tail(q, k, causal, sm_scale))
    _launch_check(err, "dkdv", q, k.shape[1], causal)
    dkdv_launches.add(kernel_route("dkdv", q.dtype, q.shape[-1]))
    return dk, dv


def _kernel_bwd(q, k, v, out, lse, dout, causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 (dq) then K3 (dk, dv) on the current stream; delta =
    rowsum(out * dout) in fp32 is one torch op before them, as the JAX
    package leaves it to XLA."""
    _check_kernel_inputs(q, k, v)
    dout = dout.contiguous()
    _check_like("dout", dout, q)
    _check_like("out", out, q)
    b, sq, h, _ = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous float32 [{b}, {h}, {sq}] "
                         f"on q's device")
    if lse.data_ptr() % 16:
        raise ValueError("the CUDA flash_attention backward takes a 16-byte "
                         "aligned lse (its rows are copied by TMA)")
    if b * h * sq > _MAX_ROWS:
        raise ValueError(f"the CUDA flash_attention backward takes at most "
                         f"{_MAX_ROWS} lse rows; got {b * h * sq}")
    if _lib is None:
        build_kernels()
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(),
                         dout.float()).contiguous()
    dq = _kernel_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale)
    dk, dv = _kernel_bwd_dkdv(q, k, v, dout, lse, delta, causal, sm_scale)
    return dq, dk, dv


def _scale(q, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def _fwd_dispatch(q, k, v, causal: bool = True,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward without autograd -> (out [B,Sq,H,D] in q's
    dtype, lse [B,H,Sq] float32). CUDA tensors launch K1 (or raise); CPU
    tensors take the plain blockwise path."""
    if q.device.type == "cuda":
        return _kernel_fwd(q, k, v, causal, _scale(q, sm_scale))
    if q.device.type == "cpu":
        return _blockwise_fwd(q, k, v, causal, _scale(q, sm_scale))
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def _bwd_dispatch(q, k, v, out, lse, dout, causal: bool = True,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's residuals. CUDA tensors launch K2
    and K3 (or raise); CPU tensors take the plain blockwise path."""
    if q.device.type == "cuda":
        return _kernel_bwd(q, k, v, out, lse, dout, causal,
                           _scale(q, sm_scale))
    if q.device.type == "cpu":
        return _blockwise_bwd(q, k, v, out, lse, dout, causal,
                              _scale(q, sm_scale))
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def _attention_op(fwd: Callable, bwd: Callable):
    """An autograd op over a (fwd -> (out, lse), bwd -> (dq, dk, dv))
    pair; residuals (q, k, v, out, lse) as the JAX package's
    ``_flash_fwd`` saves them."""

    class _Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, sm_scale):
            scale = _scale(q, sm_scale)
            out, lse = fwd(q, k, v, causal, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.scale = causal, scale
            return out

        @staticmethod
        def backward(ctx, dout):
            dq, dk, dv = bwd(*ctx.saved_tensors, dout, ctx.causal,
                             ctx.scale)
            return dq, dk, dv, None, None

    return _Attention


# the op: kernels on CUDA, blockwise on the CPU
_FlashAttention = _attention_op(_fwd_dispatch, _bwd_dispatch)
# the plain versions on any device: the kernels' yardstick on the card
_BlockwiseAttention = _attention_op(_blockwise_fwd, _blockwise_bwd)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable attention -> out [B,Sq,H,D] in q's dtype. CUDA
    tensors run K1 forward and K2/K3 backward (or raise); CPU tensors take
    the plain blockwise paths."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale)


def blockwise_attention(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` on the plain blockwise versions, on any device
    (the reference a run holds the kernels against)."""
    return _BlockwiseAttention.apply(q, k, v, causal, sm_scale)
