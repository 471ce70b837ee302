"""K1, K2 and K3 at head dims off the wgmma route's 64 and 128, against
their plain versions: the short first call after the padded wgmma
(fed by TMA or by cp.async), fp32 (the ring kernels of K1, K2 and K3)
or chunked (past 256) kernels change.

    python3 -m ray_tpu_torch.tools.check_head_dims

Builds the kernels (printing the build time; for the fp32 ring kernels
the most registers any instantiation uses and every one that spills;
for each instantiation of the padded wgmma kernels of K1, K2 and K3
(each width, consumer warpgroups and feed), of the ring kernels up to
256 (each one-slice width and copy size) and of the kernels past 256
(K1's two, and K2's and K3's wgmma kernel at each feed and their ring
kernel) its registers, spills and ptxas's performance notes, such as
wgmmas serialised for want of registers), then for each (dtype, head
dim) in ``CASES`` (and ``WIDE_CASES`` at their own shapes) runs the forward,
then K2 and K3 on its lse, at a ragged shape with Sq != Sk (causal at
even head dims, non-causal at odd ones), and holds out/lse against
``_blockwise_fwd`` and dq/dk/dv against ``_blockwise_bwd`` within
chip_smoke.py's tolerances. For K2's and K3's wgmma kernels past 256 it
reads, from the C dispatch itself, the layout each case launches
(consumer warpgroups, rows resident, ring stages, producer
warpgroups), checks that the cases reach every layout in ``LAYOUTS`` on
each feed and that every head dim past 256 to 4096 has a layout that
fits, and prints the layouts at ``LAYOUT_SHAPES``. Prints the card's
name and power limit, then one JSON line per case and one for the
layouts. Exits 1 if any case disagreed or failed or a layout was not
reached or did not fit, 2 without CUDA.
"""

from __future__ import annotations

import json
import re
import sys
import time

# (dtype, head dims): every padded instantiation's edges -- element-wise
# rows (D % 8 != 0 in bf16, D % 4 != 0 in fp32), in fp32 each one-slice
# width of the ring kernels (16, 32, 64, 128, 192, 256: D 1, 3, 16, 20,
# 33, 64, 100, 128, 160, 161, 192, 224, 256, with 4-byte copies at 1, 3,
# 33 and 161), and in bf16 the padded wgmma widths of K1, K2 and K3 at
# each feed (D rounded up to 32: 32 ... 256; a 32-column piece at 80,
# 96, 160, 224; D 72 and 200 short of their padding by 24; fed by TMA at
# D % 8 == 0, under 64 in one box (8 ... 56; K3 splitting its two
# products there), by cp.async of 8 bytes at D % 4 == 0 (20, 100), of 4
# at D % 4 == 2 (58, 90, 150, 222, 250, 258) and through registers at odd
# D (1, 33, 181, 255, 257, 301)) -- and the debug configs' 16
CASES = [
    ("bfloat16", (1, 8, 16, 20, 24, 32, 33, 40, 48, 56, 58, 72, 80, 90, 96,
                  100, 112, 136, 150, 160, 176, 181, 192, 200, 222, 224,
                  250, 255, 256,
                  # past 256: on wgmma fed by cp.async at D % 8 != 0 (a
                  # last box of one column, of 2, of 44) and by TMA at D %
                  # 8 == 0, dq's slices padded to 160 (264, 320), 192
                  # (576), 224 (448) and 256 (512), dk/dv's to 96 (264)
                  # and 128
                  257, 258, 264, 300, 301, 320, 448, 512, 576)),
    ("float32", (1, 3, 16, 20, 32, 33, 64, 100, 128, 160, 161, 192, 224,
                 255, 256, 257, 264, 300, 320, 384, 512)),
]
SHAPE = (2, 300, 237, 3)  # B, Sq, Sk, H
# (dtype, head dim, (B, Sq, Sk, H)): the wgmma kernels at shapes whose
# grids choose their other layouts. At SHAPE the bf16 wgmma kernels of K1
# and K2 take one consumer warpgroup (64-row tiles: 128-row ones would
# leave SMs idle); here two, past 256 with their rows resident (D 512,
# and 300 and 301 fed by cp.async and through registers) and streamed
# beside the tiles (D 640, ten 64-column boxes; D 650 fed by 4-byte
# cp.async), and Sq != Sk both ways; K2 past 256 with two consumer
# warpgroups and its rows resident (D 320, 384; 300 and 301 fed by
# cp.async), K2 and K3 with one and their rows resident (512, 640) and
# streamed (704: eleven boxes; 650); up to 256 the padded kernels fed by
# TMA under 64 (16), by cp.async (100) and through registers (33); fp32
# at slices of 320 and of 256 columns, with 16- and 4-byte copies (D
# 302), and up to 256 on many blocks of 64 rows (d 16 and 128, Sq != Sk)
WIDE_CASES = [
    ("bfloat16", 512, (2, 1000, 700, 8)),
    ("bfloat16", 640, (2, 700, 1000, 8)),
    ("bfloat16", 384, (2, 1000, 700, 8)),
    ("bfloat16", 300, (2, 1000, 700, 8)),
    ("bfloat16", 301, (2, 1000, 1000, 8)),
    ("bfloat16", 650, (2, 700, 1000, 8)),
    ("bfloat16", 320, (2, 1000, 700, 8)),
    ("bfloat16", 704, (2, 700, 1000, 4)),
    ("bfloat16", 16, (2, 1000, 1000, 16)),
    ("bfloat16", 33, (2, 1000, 1000, 16)),
    ("bfloat16", 100, (2, 1000, 700, 16)),
    ("float32", 320, (2, 700, 1000, 8)),
    ("float32", 302, (2, 1000, 700, 8)),
    ("float32", 512, (1, 1000, 1000, 8)),
    ("float32", 16, (2, 1000, 700, 16)),
    ("float32", 128, (2, 700, 1000, 8)),
]
# (consumer warpgroups, rows resident) of K2's and K3's wgmma kernels
# past 256: the layouts the cases must reach on each feed (K3 takes one
# consumer warpgroup)
LAYOUTS = {"dq": {(1, True), (2, True), (1, False)},
           "dkdv": {(1, True), (1, False)}}
FEEDS = ("tma", "cp_async")
# (B, Sq, Sk, H) of b1_h4's train step and of the kernel phase's
# d512_wide row, whose layouts are printed
LAYOUT_SHAPES = {"b1_h4_train": (8, 2048, 2048, 4),
                 "d512_wide": (2, 2048, 2048, 8)}
_LAYOUT_KEYS = ("swp", "sw", "ncw", "resident", "kst", "sst", "producers")
# chip_smoke.py's KERNEL_TOL and BWD_TOL, (atol, rtol)
FWD_TOL = {"bfloat16": {"out": (2e-2, 2e-2), "lse": (1e-3, 1e-4)},
           "float32": {"out": (1e-4, 1e-4), "lse": (1e-4, 1e-4)}}
BWD_TOL = {"bfloat16": (5e-2, 2e-2), "float32": (1e-5, 1e-5)}


def ptxas_summary(log: str) -> dict:
    """Most registers and every spilling kernel of the fp32 ring kernels
    (on either side of 256) in ``nvcc -Xptxas=-v``'s report."""
    name, most, spills = None, 0, []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and "ring_f32_kernel" in name:
            if "Used" in ln and "registers" in ln:
                most = max(most, int(ln.split("Used")[1].split()[0]))
            elif "spill stores" in ln and not ln.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores"):
                spills.append(f"{name}: {ln.strip()}")
    return {"most_registers": most, "spilling": spills}


def kernel_name(mangled: str) -> str:
    """A kernel template's name and arguments out of its mangled name
    ("bwd_dkdv_ws_kernel<128, 1>"), else the mangled name itself."""
    end = mangled.find("_kernelI") + len("_kernel")
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[end:])
    if end < len("_kernel") or not args:
        return mangled
    # the name follows its length in decimal
    n = next((n for n in range(len("_kernel"), end)
              if mangled[:end - n].endswith(str(n))), None)
    if n is None:
        return mangled
    values = re.findall(r"L[a-z](\d+)E", args.group(1))
    return f"{mangled[end - n:end]}<{', '.join(values)}>"


# the wgmma kernels of K1 and K3 at the padded widths, and of K2 (every
# width); the kernels past 256 at each slice width: K1's wgmma kernel (by
# consumer warpgroups and Q resident or not), K2's and K3's wgmma kernel
# (by consumer warpgroups and rows resident or not); the fp32 ring kernels
# of K1 and of K2/K3 at each shape (rows a thread, head-dim step, column
# group, groups, slice-step rows, rows resident, copy size), on both sides
# of 256
_WGMMA_ROWS = ("flash_fwd_padded_kernel<", "bwd_dq_ws_kernel<",
               "bwd_dkdv_padded_kernel<", "fwd_dchunk_wgmma_kernel<",
               "fwd_ring_f32_kernel<", "bwd_dchunk_wgmma_kernel<",
               "bwd_ring_f32_kernel<")


def wgmma_rows(log: str) -> list:
    """One row per instantiation of K1's, K2's and K3's padded wgmma
    kernels and of the kernels past 256 in ``nvcc -Xptxas=-v``'s
    report: its name and width,
    registers, spill line and any performance note (ptxas may print a
    note before its function's rows)."""
    rows, notes, row = [], {}, None
    for ln in log.splitlines():
        if "Potential Performance Loss" in ln:
            notes.setdefault(ln.split("'")[1], []).append(
                ln.split("Loss:")[1].split(" for ")[0].strip())
        elif "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name = kernel_name(mangled)
            row = None
            if name.startswith(_WGMMA_ROWS):
                row = {"kernel": name, "mangled": mangled}
                rows.append(row)
        elif row is not None and "Used" in ln and "registers" in ln:
            row["registers"] = int(ln.split("Used")[1].split()[0])
        elif row is not None and "spill stores" in ln:
            row["spill"] = ln.strip()
    for r in rows:
        r["notes"] = notes.get(r.pop("mangled"), [])
    return rows


def dchunk_layout(kernel: str, d: int, shape: tuple):
    """The layout the C dispatch of K2's (``kernel`` "dq") or K3's
    ("dkdv") wgmma kernel past 256 takes at head dim ``d`` and ``shape``
    (B, Sq, Sk, H) on its feed (TMA at d % 8 == 0, else cp.async),
    launching nothing: {"swp", "sw", "ncw", "resident", "kst", "sst",
    "producers"}, or None where no layout fits. Needs the built
    kernels."""
    import ctypes

    from ray_tpu_torch.ops import attention as T

    feed = "" if d % 8 == 0 else "cp_async_"
    fn = getattr(T._lib, f"rtt_flash_attn_bwd_{kernel}_dchunk_{feed}layout")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(_LAYOUT_KEYS))()
    b, sq, sk, h = shape
    if fn(b, h, sq, sk, d, out):
        return None
    row = dict(zip(_LAYOUT_KEYS, out))
    row["resident"] = bool(row["resident"])
    return row


def layout_report(rows: list) -> dict:
    """The (consumer warpgroups, rows resident) layouts ``rows`` reached
    on each feed against LAYOUTS, the head dims past 256 to 4096 (at B1
    S1000 H4) with no layout that fits, and the layouts at LAYOUT_SHAPES
    (d 512, and d 511 on the other feed); "ok" when every layout was
    reached on both feeds and every head dim fits."""
    wanted = {f"{kernel}_{feed}": v for kernel, v in LAYOUTS.items()
              for feed in FEEDS}
    reached = {key: set() for key in wanted}
    for row in rows:
        feed = FEEDS[row["D"] % 8 != 0]
        for kernel, got in row.get("layouts", {}).items():
            if got:
                reached[f"{kernel}_{feed}"].add((got["ncw"],
                                                 got["resident"]))
    no_fit = [(kernel, d) for d in range(257, 4097) for kernel in LAYOUTS
              if dchunk_layout(kernel, d, (1, 1000, 1000, 4)) is None]
    return {"layouts_reached": {k: sorted(v) for k, v in reached.items()},
            "layouts_wanted": {k: sorted(v) for k, v in wanted.items()},
            "no_fit": no_fit,
            "at": {f"{name} d{d}": {kernel: dchunk_layout(kernel, d, shape)
                                    for kernel in LAYOUTS}
                   for name, shape in LAYOUT_SHAPES.items()
                   for d in (512, 511)},
            "ok": reached == wanted and not no_fit}


def run_case(dtype: str, d: int, shape: tuple = SHAPE) -> dict:
    import torch

    from ray_tpu_torch.ops import attention as T

    b, sq, sk, h = shape
    causal = d % 2 == 0
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(d)
    q, do = (torch.randn((b, sq, h, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((b, sk, h, d), generator=g, device="cuda").to(dt)
            for _ in range(2))
    scale = d ** -0.5
    out, lse = T._fwd_dispatch(q, k, v, causal)
    got = T._kernel_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    p_out, p_lse = T._blockwise_fwd(q, k, v, causal, scale)
    want = T._blockwise_bwd(q, k, v, out, lse, do, causal, scale)
    row = {"dtype": dtype, "D": d, "shape": list(shape), "causal": causal,
           "routes": {kernel: T.kernel_route(kernel, dt, d)
                      for kernel in ("fwd", "dq", "dkdv")},
           "err": {}, "agree": True}
    pairs = [("out", out, p_out, FWD_TOL[dtype]["out"]),
             ("lse", lse, p_lse, FWD_TOL[dtype]["lse"])]
    pairs += [(n, x, y, BWD_TOL[dtype])
              for n, x, y in zip(("dq", "dk", "dv"), got, want)]
    if dtype == "bfloat16" and row["routes"]["dq"] in (T.DCHUNK_WGMMA,
                                                       T.DCHUNK_WGMMA_CP):
        row["layouts"] = {kernel: dchunk_layout(kernel, d, shape)
                          for kernel in LAYOUTS}
    for name, x, y, (atol, rtol) in pairs:
        row["err"][name] = (x.float() - y.float()).abs().max().item()
        row["agree"] &= bool(torch.isfinite(x).all()) and torch.allclose(
            x.float(), y.float(), atol=atol, rtol=rtol)
    return row


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_head_dims: no CUDA device visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import attention as T
    from ray_tpu_torch.tools.profile_serving import card_line

    print(card_line(), flush=True)
    t0 = time.monotonic()
    log = T.build_kernels()
    print(json.dumps({"build_s": time.monotonic() - t0,
                      **ptxas_summary(log)}), flush=True)
    for row in wgmma_rows(log):
        print(json.dumps(row), flush=True)
    failed, rows = 0, []
    cases = [(dtype, d, SHAPE) for dtype, dims in CASES for d in dims]
    for dtype, d, shape in cases + WIDE_CASES:
        try:
            row = run_case(dtype, d, shape)
        except Exception as exc:  # report the rest of the cases too
            row = {"dtype": dtype, "D": d, "shape": list(shape),
                   "error": repr(exc)[:300], "agree": False}
        failed += not row["agree"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    layouts = layout_report(rows)
    failed += not layouts["ok"]
    print(json.dumps(layouts), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
