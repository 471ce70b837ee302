"""The fp32 kernels on the host CPU: K1's and K3's ring kernels up to head
dim 256 (route ``fma_f32_ring``), K1's, K2's and K3's past it
(``dchunk_fma_f32_ring``) and K2's FMA kernel (``fma_f32``), held against
``attention._blockwise_fwd`` / ``_blockwise_bwd``.

    python3 -m ray_tpu_torch.tools.emulate_ring [D ...]

The sources in ``ops/csrc`` are copied with their inline asm (cp.async,
its commits and waits, named barriers) and their launches replaced by the
hooks of ``ring_emu/cuda_runtime.h``, which runs a block's threads as OS
threads (blocks one after another) with barriers for ``__syncthreads``,
the key groups' named barriers, ``__syncwarp`` and the shuffles, and a
cp.async as a synchronous copy. The host C++ compiler (``c++``, C++20)
builds them with ``ring_emu/harness.cpp`` into the git-ignored
``ops/_build/emu_<digest>/`` (once per source digest), loaded with ctypes.
So the kernels' index arithmetic, masks, rings, slice plans and key-group
hand-offs run on a machine without a card; nothing here times anything
or says anything about the card's compiler (register use, spills). Each
case prints one line; exits 1 if any disagreed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_EMU = _HERE / "ring_emu"
_CSRC = _HERE.parent / "ops" / "csrc"
_BUILD = _HERE.parent / "ops" / "_build"
# the sources the fp32 C dispatch reaches, and what they include
SOURCES = ("flash_attn_fwd_fma_ring.cu", "flash_attn_bwd_dkdv_fma_ring.cu",
           "flash_attn_dchunk_fma.cu", "flash_attn_dchunk_bwd_dq_fma.cu",
           "flash_attn_dchunk_bwd_dkdv_fma.cu", "flash_attn_bwd_fma.cu")
HEADERS = ("flash_attn_common.cuh", "flash_attn_routes.cuh",
           "flash_attn_ring_f32.cuh")
# entry point -> (kernel, outputs): the C launcher each calls
ENTRIES = {"emu_fwd_fma_ring": ("fwd", 2), "emu_fwd_dchunk_fma": ("fwd", 2),
           "emu_bwd_dkdv_fma_ring": ("dkdv", 2),
           "emu_bwd_dkdv_dchunk_fma": ("dkdv", 2),
           "emu_bwd_dq_dchunk_fma": ("dq", 1), "emu_bwd_dq_fma": ("dq", 1)}
# kernel vs plain version, (atol, rtol): summation order only, as
# chip_smoke.py's KERNEL_TOL and BWD_TOL in fp32
FWD_TOL = (1e-4, 1e-4)
BWD_TOL = (1e-5, 1e-5)

# an asm statement: its text up to the ");" closing it (operands hold one
# level of parentheses)
_ASM = r'asm volatile\("{}(?:[^()]|\([^()]*\))*\);'
_HOOKS = (
    (_ASM.format(r"cp\.async\.cg\.shared\.global"),
     "emu_cp(dst, src, 4, valid); (void)d;"),
    (_ASM.format(r"cp\.async\.ca\.shared\.global"),
     "emu_cp(dst, src, 1, valid); (void)d;"),
    (_ASM.format(r"bar\.sync"), "emu_group_sync(id);"),
    (_ASM.format(r"cp\.async\.commit_group"), ""),
    (_ASM.format(r"cp\.async\.wait_group"), ""),
)
# name<args...> (or name) <<<grid, threads, smem, stream>>>(args);
_LAUNCH = re.compile(r"(\w+(?:<[^;{}]*?>)?)\s*<<<(\w+),\s*([^,]+?),[^>]*>>>"
                     r"\(([^;]*)\);")


def translate(text: str) -> str:
    """A source with its asm and launches turned into the hooks."""
    for pattern, hook in _HOOKS:
        text = re.sub(pattern, hook, text)
    text = _LAUNCH.sub(lambda m: f"emu_launch({m.group(2)}, {m.group(3)}, "
                       f"[&] {{ {m.group(1)}({m.group(4)}); }});", text)
    text = text.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = ::emu_smem;")
    if "asm volatile" in text or "<<<" in text or "extern __shared__" in text:
        raise ValueError("a construct the emulation does not translate")
    return text


def _compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "c++")) or shutil.which("g++")
    if not found:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")
    return found


def build() -> ctypes.CDLL:
    """The emulated kernels as a loaded library (built once per digest of
    the sources and the emulation)."""
    inputs = [_CSRC / n for n in (*SOURCES, *HEADERS)] + [
        _EMU / n for n in ("cuda_runtime.h", "cuda_bf16.h", "harness.cpp")]
    digest = hashlib.sha256(b"".join(
        p.read_bytes() for p in inputs)).hexdigest()[:16]
    out = _BUILD / f"emu_{digest}"
    lib = out / "libring_emu.so"
    if not lib.exists():
        tmp = _BUILD / f".emu_{digest}.{os.getpid()}"
        src = tmp / "src"
        src.mkdir(parents=True, exist_ok=True)
        try:
            for name in (*SOURCES, *HEADERS):
                (src / name).write_text(translate((_CSRC / name).read_text()))
            flags = ["-std=c++20", "-O1", "-fPIC", "-pthread", "-w",
                     f"-I{_EMU}", f"-I{src}", "-x", "c++"]
            units = [src / n for n in SOURCES] + [_EMU / "harness.cpp"]
            objs = [tmp / f"{p.stem}.o" for p in units]
            procs = [subprocess.Popen([_compiler(), *flags, "-c", str(u),
                                       "-o", str(o)],
                                      stderr=subprocess.PIPE, text=True)
                     for u, o in zip(units, objs)]
            errs = [p.communicate()[1] for p in procs]
            if any(p.returncode for p in procs):
                raise RuntimeError("emulation build failed:\n"
                                   + "".join(errs)[-4000:])
            subprocess.run([_compiler(), "-shared", "-pthread", "-o",
                            str(tmp / lib.name), *map(str, objs)],
                           check=True)
            out.mkdir(parents=True, exist_ok=True)
            os.replace(tmp / lib.name, lib)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    so = ctypes.CDLL(str(lib))
    for name, (kernel, _) in ENTRIES.items():
        fn = getattr(so, name)
        n_ptrs = 5 if kernel == "fwd" else 8
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_float])
        fn.restype = ctypes.c_int
    return so


def run(lib, entry: str, q, k, v, causal: bool, scale: float, dout=None,
        lse=None, delta=None):
    """One emulated launch on contiguous fp32 CPU tensors [B, S, H, D] (lse
    and delta [B, H, Sq]); returns its outputs (out, lse), (dq,) or (dk,
    dv), filled with NaN before the launch."""
    import torch

    kernel, n_out = ENTRIES[entry]
    b, sq, h, d = q.shape
    sk = k.shape[1]
    like = q if kernel in ("fwd", "dq") else k
    outs = [torch.full_like(like, float("nan"))]
    if kernel == "fwd":
        outs.append(torch.full((b, h, sq), float("nan")))
    elif n_out == 2:
        outs.append(torch.full_like(k, float("nan")))
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if kernel != "fwd":
        ptrs += [dout.data_ptr(), lse.data_ptr(), delta.data_ptr()]
    ptrs += [o.data_ptr() for o in outs] + [None] * (
        0 if kernel == "fwd" or n_out == 2 else 1)
    err = getattr(lib, entry)(*ptrs, b, h, sq, sk, d, int(causal), scale)
    if err:
        raise RuntimeError(f"{entry} returned cudaError {err}")
    return tuple(outs)


def check(lib, d: int, b: int = 1, sq: int = 150, sk: int = 130,
          h: int = 2, causal: bool = True, seed: int = 0) -> dict:
    """K1, K2 and K3 at one shape on the routes fp32 takes at head dim
    ``d``, against the plain versions: {"errors": {...}, "agree": bool}."""
    import torch

    from ray_tpu_torch.ops import attention as T

    g = torch.Generator().manual_seed(seed + d)
    q, do = (torch.randn(b, sq, h, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=g) for _ in range(2))
    scale = d ** -0.5
    past = d > T.DCHUNK_PAST
    out, lse = run(lib, "emu_fwd_dchunk_fma" if past else "emu_fwd_fma_ring",
                   q, k, v, causal, scale)
    p_out, p_lse = T._blockwise_fwd(q, k, v, causal, scale)
    delta = torch.einsum("bqhd,bqhd->bhq", p_out, do).contiguous()
    p_lse = p_lse.contiguous()
    bwd = dict(dout=do, lse=p_lse, delta=delta)
    (dq,) = run(lib, "emu_bwd_dq_dchunk_fma" if past else "emu_bwd_dq_fma",
                q, k, v, causal, scale, **bwd)
    dk, dv = run(lib, "emu_bwd_dkdv_dchunk_fma" if past
                 else "emu_bwd_dkdv_fma_ring", q, k, v, causal, scale, **bwd)
    want = T._blockwise_bwd(q, k, v, p_out, p_lse, do, causal, scale)
    pairs = [("out", out, p_out, FWD_TOL), ("lse", lse, p_lse, FWD_TOL)]
    pairs += [(n, x, y, BWD_TOL)
              for n, x, y in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
    row = {"D": d, "shape": [b, sq, sk, h], "causal": causal,
           "errors": {}, "agree": True}
    for name, x, y, (atol, rtol) in pairs:
        row["errors"][name] = (x - y).abs().max().item()
        row["agree"] &= bool(torch.isfinite(x).all()) and torch.allclose(
            x, y, atol=atol, rtol=rtol)
    return row


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    dims = [int(a) for a in args] or [1, 3, 16, 17, 33, 64, 100, 128, 130,
                                      192, 255, 256, 257, 300, 320]
    lib = build()
    failed = 0
    for d in dims:
        for causal in (True, False):
            row = check(lib, d, causal=causal)
            failed += not row["agree"]
            print(row, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
