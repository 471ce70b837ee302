"""Host-side logic around the hand-written flash-attention kernels, on the
CPU: which kernel each (kernel, dtype, head_dim) takes, the launch counts
by route, the input checks that raise before anything is built, and the
error a refused launch raises.

The kernels themselves run only on a card (chip_smoke.py holds each one
against its plain version there); nothing here builds or launches one.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from ray_tpu_torch.ops import attention as T

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kernel,dtype,head_dim,route", [
    # K1 and K3 in bf16 at head_dim 64 and 128: wgmma on TMA rings
    ("fwd", torch.bfloat16, 128, T.WGMMA),
    ("fwd", torch.bfloat16, 64, T.WGMMA),
    ("dkdv", torch.bfloat16, 128, T.WGMMA),
    ("dkdv", torch.bfloat16, 64, T.WGMMA),
    # under 64 all three take their padded wgmma kernels fed by TMA at D %
    # 8 == 0 (one 64-column box, zeros past D: the debug configs' 16, 32,
    # 48 and the entry config's 32; more at the end)
    ("fwd", torch.bfloat16, 32, T.WGMMA_PADDED),
    ("dkdv", torch.bfloat16, 32, T.WGMMA_PADDED),
    ("fwd", torch.bfloat16, 16, T.WGMMA_PADDED),
    ("fwd", torch.bfloat16, 48, T.WGMMA_PADDED),
    # K1, K2 and K3 take the padded wgmma kernels at D % 8 == 0 between
    # 64 and 256 (bench.py's xl width's 160, the widest 256, and 72, 96,
    # 192: a 24-column pad, a 32-column piece, three boxes) ...
    ("fwd", torch.bfloat16, 160, T.WGMMA_PADDED),
    ("fwd", torch.bfloat16, 72, T.WGMMA_PADDED),
    ("fwd", torch.bfloat16, 96, T.WGMMA_PADDED),
    ("fwd", torch.bfloat16, 192, T.WGMMA_PADDED),
    ("fwd", torch.bfloat16, 256, T.WGMMA_PADDED),
    ("dq", torch.bfloat16, 160, T.WGMMA_PADDED),
    ("dkdv", torch.bfloat16, 256, T.WGMMA_PADDED),
    ("dq", torch.bfloat16, 72, T.WGMMA_PADDED),
    ("dkdv", torch.bfloat16, 72, T.WGMMA_PADDED),
    ("dq", torch.bfloat16, 96, T.WGMMA_PADDED),
    ("dkdv", torch.bfloat16, 96, T.WGMMA_PADDED),
    ("dq", torch.bfloat16, 192, T.WGMMA_PADDED),
    ("dkdv", torch.bfloat16, 192, T.WGMMA_PADDED),
    # ... and where a row is not a multiple of 16 bytes all three on
    # their padded wgmma kernels fed by cp.async
    ("fwd", torch.bfloat16, 100, T.WGMMA_PADDED_CP),
    ("fwd", torch.bfloat16, 250, T.WGMMA_PADDED_CP),
    ("dq", torch.bfloat16, 100, T.WGMMA_PADDED_CP),
    ("dkdv", torch.bfloat16, 100, T.WGMMA_PADDED_CP),
    ("dq", torch.bfloat16, 250, T.WGMMA_PADDED_CP),
    ("dkdv", torch.bfloat16, 250, T.WGMMA_PADDED_CP),
    # K2 follows K3's rule: wgmma at 64 and 128, the padded kernel at 32
    ("dq", torch.bfloat16, 128, T.WGMMA),
    ("dq", torch.bfloat16, 64, T.WGMMA),
    ("dq", torch.bfloat16, 32, T.WGMMA_PADDED),
    # float32 up to 256: K1 and K3 on their ring kernels, K2 on its FMA
    # kernel
    ("fwd", torch.float32, 128, T.FMA_RING),
    ("dq", torch.float32, 64, T.FMA),
    ("dkdv", torch.float32, 32, T.FMA_RING),
    # past 256, both dtypes (the kernel phase's rows at 264, 320 and
    # 512): all three on the Hopper kernels, wgmma in bf16 at D % 8 == 0
    # and the ring-fed FMA kernels in fp32
    ("fwd", torch.bfloat16, 264, T.DCHUNK_WGMMA),
    ("dq", torch.bfloat16, 320, T.DCHUNK_WGMMA),
    ("dkdv", torch.bfloat16, 512, T.DCHUNK_WGMMA),
    ("fwd", torch.float32, 320, T.DCHUNK_FMA),
    ("dq", torch.float32, 264, T.DCHUNK_FMA),
    ("dkdv", torch.float32, 257, T.DCHUNK_FMA),
    # K1 in bf16 past 256 off the multiples of 8 (a row stride TMA cannot
    # take) on its wgmma kernel fed by cp.async; fp32 K1 takes every D
    ("fwd", torch.bfloat16, 300, T.DCHUNK_WGMMA_CP),
    ("fwd", torch.bfloat16, 257, T.DCHUNK_WGMMA_CP),
    ("fwd", torch.bfloat16, 512, T.DCHUNK_WGMMA),
    ("fwd", torch.bfloat16, 384, T.DCHUNK_WGMMA),
    ("fwd", torch.float32, 257, T.DCHUNK_FMA),
    ("fwd", torch.float32, 300, T.DCHUNK_FMA),
    ("dq", torch.bfloat16, 512, T.DCHUNK_WGMMA),
    ("dkdv", torch.float32, 320, T.DCHUNK_FMA),
    # K1 under 64 fed by TMA (8) and by cp.async off the multiples of 8
    # (odd D through registers: 33, 1, and past 256 301)
    ("fwd", torch.bfloat16, 8, T.WGMMA_PADDED),
    ("fwd", torch.bfloat16, 33, T.WGMMA_PADDED_CP),
    ("fwd", torch.bfloat16, 20, T.WGMMA_PADDED_CP),
    ("fwd", torch.bfloat16, 1, T.WGMMA_PADDED_CP),
    ("fwd", torch.bfloat16, 301, T.DCHUNK_WGMMA_CP),
    # K2 and K3 in bf16 past 256 off the multiples of 8 on their wgmma
    # kernel fed by cp.async (through registers at 301)
    ("dq", torch.bfloat16, 300, T.DCHUNK_WGMMA_CP),
    ("dkdv", torch.bfloat16, 301, T.DCHUNK_WGMMA_CP),
    ("dkdv", torch.bfloat16, 264, T.DCHUNK_WGMMA),
])
def test_kernel_route(kernel, dtype, head_dim, route):
    assert T.kernel_route(kernel, dtype, head_dim) == route


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkdv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_route_takes_every_head_dim_to_256(kernel, dtype):
    """Every head dim has a kernel, the same for K1, K2 and K3: bf16
    keeps wgmma at 64 and 128 and takes the padded wgmma kernels at every
    other head dim up to 256, fed by TMA at the multiples of 8 and by
    cp.async off them; fp32 takes the ring kernels (K1, K3) and the FMA
    kernel (K2) at all up to 256; past 256, with no upper bound, all three
    take the wgmma kernels in bf16 (fed by TMA at D % 8 == 0, by cp.async
    off it) and the ring-fed FMA kernels in fp32; 0 raises."""
    padded = [d for d in range(1, T.DCHUNK_PAST + 1)
              if d % 8 == 0 and d not in (64, 128)]
    assert len(padded) == 30 and padded[0] == 8 and padded[-1] == 256
    for d in range(1, T.DCHUNK_PAST + 1):
        fp32 = T.FMA if kernel == "dq" else T.FMA_RING
        want = (fp32 if dtype == torch.float32 else
                T.WGMMA if d in (64, 128) else
                T.WGMMA_PADDED if d in padded else T.WGMMA_PADDED_CP)
        assert T.kernel_route(kernel, dtype, d) == want, d
        assert T.wgmma_padded_head_dim(d) == (d in padded), d
    for d in (T.DCHUNK_PAST + 1, 264, 300, 320, 512, 4096):
        want = (T.DCHUNK_FMA if dtype == torch.float32 else
                T.DCHUNK_WGMMA if d % 8 == 0 else T.DCHUNK_WGMMA_CP)
        assert T.kernel_route(kernel, dtype, d) == want, d
        assert not T.wgmma_padded_head_dim(d)
    with pytest.raises(ValueError, match="head_dim"):
        T.kernel_route(kernel, dtype, 0)


@pytest.mark.parametrize("kernel,dtype,head_dim,error", [
    ("fwd", torch.float16, 128, TypeError),
    ("dkdv", torch.float16, 264, TypeError),
    ("fwd", torch.bfloat16, 0, ValueError),
    ("bwd", torch.bfloat16, 128, ValueError),
])
def test_kernel_route_raises_for_what_no_kernel_takes(kernel, dtype,
                                                      head_dim, error):
    with pytest.raises(error):
        T.kernel_route(kernel, dtype, head_dim)


def test_launch_count_by_route():
    """A count adds up its launches in all and by route; reset clears
    both, and by_route hands out a copy."""
    count = T.LaunchCount()
    for route in (T.WGMMA, T.WGMMA, T.WGMMA_PADDED_CP):
        count.add(route)
    assert count.count == 3
    seen = count.by_route
    assert seen == {T.WGMMA: 2, T.WGMMA_PADDED_CP: 1}
    seen[T.FMA] = 7
    assert T.FMA not in count.by_route
    count.reset()
    assert (count.count, count.by_route) == (0, {})


def _bf16(shape, offset=0):
    """A contiguous bf16 tensor of ``shape`` whose data starts ``offset``
    elements into its storage (offset 1: 2 bytes off 16-byte alignment)."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


def test_wgmma_route_inputs_must_be_contiguous_and_aligned():
    """The tensor maps address q/k/v as [B, S, H, D] from a 16-byte
    aligned base: a transposed view or a base 2 bytes off raises."""
    shape = (1, 64, 2, 128)
    good = _bf16(shape)
    T._check_kernel_inputs(good, good, good)
    strided = _bf16((1, 2, 64, 128)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous, 16-byte aligned q"):
        T._check_kernel_inputs(strided, good, good)
    with pytest.raises(ValueError, match="contiguous, 16-byte aligned k"):
        T._check_kernel_inputs(good, _bf16(shape, offset=1), good)


@pytest.mark.parametrize("bad", ["dout", "lse"])
def test_backward_checks_raise_before_any_build(bad):
    """K2 and K3 copy dO by TMA, K3 the lse rows too: a misaligned dout
    or lse raises in the wrapper, before a kernel is built or launched."""
    b, s, h, d = 1, 64, 2, 128
    q = _bf16((b, s, h, d))
    dout = _bf16((b, s, h, d), offset=1) if bad == "dout" else q
    lse = torch.zeros(b * h * s + 1)[1:].view(b, h, s) if bad == "lse" \
        else torch.zeros(b, h, s)
    with pytest.raises(ValueError, match=bad):
        T._kernel_bwd(q, q, q, q, lse, dout, True, d ** -0.5)
    assert T._lib is None
    assert (T.dq_launches.count, T.dkdv_launches.count) == (0, 0)


@pytest.mark.parametrize("err,cause", [
    (1000 + 1, "cuTensorMapEncodeTiled returned CUresult 1"),
    (1, "cudaError 1"),
])
def test_refused_launch_names_its_cause_and_route(err, cause):
    q = _bf16((1, 64, 2, 128))
    with pytest.raises(RuntimeError) as info:
        T._launch_check(err, "dkdv", q, 64, True)
    assert cause in str(info.value) and T.WGMMA in str(info.value)
    T._launch_check(0, "fwd", q, 64, True)


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkdv"])
def test_refused_padded_launch_raises_with_its_route(kernel):
    """No fallback at the padded head dims: a tensor map the launcher
    could not make, or a refused launch, raises naming the padded wgmma
    route (nothing gives way to mma.sync or the plain version)."""
    q = _bf16((1, 64, 2, 160))
    for err in (1000 + 1, 1):
        with pytest.raises(RuntimeError, match=T.WGMMA_PADDED):
            T._launch_check(err, kernel, q, 64, True)


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch and the port lazily,
    so loading it builds and launches nothing)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel,bound_ms", [
    # b1's train step, B8 S2048 H16 D128 causal bf16: 2,098,176 kept
    # pairs a head, 2*d FLOPs a pair and product (fwd 2, dq 3, dk/dv 4
    # products) over 989 TFLOP/s, far above bytes over 3.35 TB/s
    ("fwd", 0.1390),
    ("dq", 0.2086),
    ("dkdv", 0.2781),
])
def test_attention_bound_at_the_train_shape(kernel, bound_ms):
    """The bound chip_smoke.py reports, and PERF.md quotes, for each
    kernel at the train shape: operations, at these milliseconds."""
    got, bound_by = _chip_smoke()._attention_work(
        kernel, 8, 2048, 2048, 16, 128, True, "bfloat16")
    assert bound_by == "operations"
    assert got == pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("shape,kernel,bound_ms,bound_by", [
    # the MoE train step, B16 S2048 H16 D64 causal bf16: the same kept
    # pairs x d as b1's train shape (half the head dim, twice the batch),
    # so the same operation bounds
    ("moe", "fwd", 0.1390, "operations"),
    ("moe", "dq", 0.2086, "operations"),
    ("moe", "dkdv", 0.2781, "operations"),
    # ViT-B/16's train step, B128 S197 H12 D64 non-causal bf16: 197^2
    # pairs a head are too few to outweigh the bytes (each q/k/v/out row
    # 128 bytes, read or written once) over 3.35 TB/s
    ("vit", "fwd", 0.04661, "bytes"),
    ("vit", "dq", 0.05853, "bytes"),
    ("vit", "dkdv", 0.07009, "bytes"),
])
def test_attention_bound_at_the_moe_and_vit_shapes(shape, kernel, bound_ms,
                                                   bound_by):
    """The kernel phase's rows at the two new model paths' shapes, and
    the bound chip_smoke.py reports for each kernel there."""
    cs = _chip_smoke()
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    b, s, h, d, causal, dtype = fwd[shape]
    assert bwd[shape] == (b, s, s, h, d, causal, dtype)
    assert (h, d, dtype) == ((16, 64, "bfloat16") if shape == "moe"
                             else (12, 64, "bfloat16"))
    got, by = cs._attention_work(kernel, b, s, s, h, d, causal, dtype)
    assert by == bound_by
    assert got == pytest.approx(bound_ms, abs=5e-5)


def test_check_dq_keeps_only_the_named_kernels_ptxas_lines():
    """tools/check_dq prints ptxas's report of bwd_dq_ws_kernel and of no
    other function (its name, then its registers and spills)."""
    from ray_tpu_torch.tools.check_dq import ptxas_rows

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z18bwd_dq_ws_kernelILi128EEv' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function "
        "'_Z20bwd_dkdv_ws_kernelILi128EEv' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
    ])
    rows = ptxas_rows(log, "bwd_dq_ws_kernel")
    assert len(rows) == 3
    assert "bwd_dq_ws_kernel" in rows[0] and "168 registers" in rows[1]
    assert ptxas_rows(log, "flash_fwd_ws_kernel") == []


def test_check_bwd_rows_covers_every_row_alignment():
    """tools/check_bwd_rows runs K3 at Sq % 4 of 0, 1, 2 and 3 (the
    offset of a tile's lse/delta rows off a 16-byte boundary), past head
    dim 256 too, K2 beside it, and ViT-B/16's train shape; without CUDA
    it exits 2."""
    from ray_tpu_torch.tools import check_bwd_rows

    k3 = {s % 4 for kernel, _, s, *_ in check_bwd_rows.CASES
          if kernel == "dkdv"}
    assert k3 == {0, 1, 2, 3}
    # K3's wgmma kernel past 256 copies its rows the same way
    assert {s % 4 for kernel, _, s, _, d, _ in check_bwd_rows.CASES
            if kernel == "dkdv" and d > 256} == {1, 3}
    assert {c[0] for c in check_bwd_rows.CASES} == {"dq", "dkdv"}
    assert ("dkdv", 128, 197, 12, 64, False) in check_bwd_rows.CASES
    if not torch.cuda.is_available():
        assert check_bwd_rows.main([]) == 2


def test_xl16_path_is_bench_xl_at_16_heads():
    """chip_smoke.py's xl16 phase trains bench.py's xl dims (hidden 2560,
    16 layers, inter 6912) at 16 heads over 8 kv heads: head_dim 160,
    where K1, K2 and K3 take the padded wgmma kernels; its kernel rows
    run at the train step's attention shape."""
    cs = _chip_smoke()
    cfg = cs._text_config("xl16")
    assert (cfg.hidden, cfg.layers, cfg.intermediate, cfg.vocab_size) == (
        2560, 16, 6912, 32000)
    assert (cfg.heads, cfg.kv_heads, cfg.head_dim) == (16, 8, 160)
    assert cfg.remat and cfg.remat_policy == "full"
    assert cfg.logits_chunk == 256 and cfg.dtype == torch.bfloat16
    assert cs._main_path_routes("bfloat16", cfg.head_dim) == {
        "fwd": T.WGMMA_PADDED, "dq": T.WGMMA_PADDED,
        "dkdv": T.WGMMA_PADDED}
    b, s = cs.TRAIN_TOKENS[0], cs.TRAIN_TOKENS[1] - 1
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    assert fwd["xl16_train"] == (b, s, cfg.heads, 160, True, "bfloat16")
    assert bwd["xl16_train"] == (b, s, s, cfg.heads, 160, True, "bfloat16")
    assert tuple(cs._train_batch("xl16").shape) == cs.TRAIN_TOKENS


@pytest.mark.parametrize("shape,sq,sk,d,causal", [
    # an N of 80 (padded to 96) where the last key tiles see no query
    ("d80_sq_lt_sk", 700, 1000, 80, True),
    # one whole box past 128, without the causal bound
    ("d192_noncausal", 1000, 1000, 192, False),
    # padded to 128, Sq > Sk (the rows past Sk see every key)
    ("d120_sq_gt_sk", 1000, 700, 120, True),
    # a 32-column piece past three boxes, at a long causal length
    ("d224", 2048, 2048, 224, True),
])
def test_padded_route_rows_reach_its_edges(shape, sq, sk, d, causal):
    """The kernel phase's rows for the padded wgmma kernels: forward and
    backward at the same shape, listed with the head-dim rows."""
    cs = _chip_smoke()
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    b, got_sq, got_sk, h, got_d, got_causal, dtype = bwd[shape]
    assert (got_sq, got_sk, got_d, got_causal, dtype) == (
        sq, sk, d, causal, "bfloat16")
    row = fwd[shape]
    assert row[:6] == (b, sq, h, d, causal, "bfloat16")
    assert (row[6] if len(row) > 6 else sq) == sk
    assert shape in cs.HEAD_DIM_SHAPES and "xl16_train" in cs.HEAD_DIM_SHAPES
    for kernel in ("fwd", "dq", "dkdv"):
        assert T.kernel_route(kernel, torch.bfloat16, d) == T.WGMMA_PADDED


def test_padded_forward_source_is_built_and_instantiated_at_each_width():
    """The padded K1 is built from one kernel header by two sources every
    build compiles (fed by TMA, by cp.async), and its launcher
    instantiates the kernel at each width the head dims it takes round up
    to (D rounded up to 32)."""
    assert {"flash_attn_fwd_padded.cu",
            "flash_attn_fwd_padded_cp_async.cu"} <= set(T._SOURCES)
    assert "flash_attn_fwd_padded.cuh" in T._HEADERS
    src = (ROOT / "ray_tpu_torch" / "ops" / "csrc"
           / "flash_attn_fwd_padded.cuh").read_text()
    widths = {(d + 31) // 32 * 32 for d in range(1, T.DCHUNK_PAST + 1)
              if T.kernel_route("fwd", torch.bfloat16, d) in (
                  T.WGMMA_PADDED, T.WGMMA_PADDED_CP)}
    assert widths == {32, 64, 96, 128, 160, 192, 224, 256}
    launched = {int(w) for w in
                re.findall(r"integral_constant<int, (\d+)>", src)}
    assert launched == widths
    # every wait is mbar_wait_no_trap: a trap anywhere in the kernel keeps
    # ptxas allocating its consumers within 168 registers
    code = re.sub(r"//[^\n]*", "", src)
    assert "__trap" not in code and "mbar_wait(" not in code
    assert "mbar_wait_no_trap(" in code
    # the C entry dispatches to the TMA-fed kernel before the other feed
    entry = (ROOT / "ray_tpu_torch" / "ops" / "csrc"
             / "flash_attn_fwd.cu").read_text()
    assert entry.index("rtt::fwd_padded(") < entry.index(
        "rtt::fwd_padded_cp_async(")


@pytest.mark.parametrize("kernel,bound_ms", [
    # the xl16 train step, B8 S2048 H16 D160 causal bf16: b1's train shape
    # at 160/128 of its head dim, so 1.25x its operation bounds
    ("fwd", 0.1738),
    ("dq", 0.2607),
    ("dkdv", 0.3476),
])
def test_attention_bound_at_the_xl16_shape(kernel, bound_ms):
    got, bound_by = _chip_smoke()._attention_work(
        kernel, 8, 2048, 2048, 16, 160, True, "bfloat16")
    assert bound_by == "operations"
    assert got == pytest.approx(bound_ms, abs=5e-5)


def test_check_head_dims_names_kernels_from_their_mangled_names():
    """tools/check_head_dims (and chip_smoke.py's build phase) print each
    wgmma kernel as name<arguments>."""
    from ray_tpu_torch.tools.check_head_dims import kernel_name as name

    assert name("_ZN54_GLOBAL__N__abc_21_flash_attn_bwd_cu_b2cda7d118"
                "bwd_dkdv_ws_kernelILi128ELb1EEEv14CUtensorMap_st") == (
        "bwd_dkdv_ws_kernel<128, 1>")
    assert name("_ZN62_GLOBAL__N__93e5_29_flash_attn_bwd_dkdv_padded_cu_"
                "4c1749c222bwd_dkdv_padded_kernelILi192EEEv14CUtensorMap_st"
                ) == "bwd_dkdv_padded_kernel<192>"
    assert name("_Z16bwd_dq_ws_kernelILi160ELb0EEv") == (
        "bwd_dq_ws_kernel<160, 0>")
    assert name("_Z3fooi") == "_Z3fooi"


def test_check_head_dims_reports_each_wgmma_backward_instantiation():
    """tools/check_head_dims prints one row per instantiation of K1's, K2's
    and K3's padded wgmma kernels: its width, registers, spills and
    ptxas's notes (which may come before the function's own rows); other
    functions' rows are left out."""
    from ray_tpu_torch.tools.check_head_dims import CASES, wgmma_rows

    k3 = "_Z22bwd_dkdv_padded_kernelILi192EEv"
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z16bwd_dq_ws_kernelILi160ELb0EEv' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to insufficient register "
        f"resources for the function '{k3}'",
        f"ptxas info    : Compiling entry function '{k3}' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Compiling entry function '_Z3foov' for 'sm_90a'",
        "ptxas info    : Used 16 registers",
        "ptxas info    : Compiling entry function '_ZN62_GLOBAL__N__93e5_"
        "29_flash_attn_fwd_padded_cu_4c1749c223flash_fwd_padded_kernel"
        "ILi160EEEv14CUtensorMap_st' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ])
    rows = wgmma_rows(log)
    assert [r["kernel"] for r in rows] == ["bwd_dq_ws_kernel<160, 0>",
                                           "bwd_dkdv_padded_kernel<192>",
                                           "flash_fwd_padded_kernel<160>"]
    assert rows[2]["registers"] == 168 and rows[2]["notes"] == []
    assert rows[0]["registers"] == 168 and rows[0]["notes"] == []
    assert "8 bytes spill stores" in rows[1]["spill"]
    assert rows[1]["notes"] == [
        "wgmma.mma_async instructions are serialized due to insufficient "
        "register resources"]
    # every padded width (D rounded up to 32) on both sides of D % 8
    bf16 = dict(CASES)["bfloat16"]
    widths = {32, 64, 96, 128, 160, 192, 224, 256}
    assert {(d + 31) // 32 * 32 for d in bf16
            if T.wgmma_padded_head_dim(d)} == widths
    assert {(d + 31) // 32 * 32 for d in bf16 if d <= T.DCHUNK_PAST
            and T.kernel_route("dq", torch.bfloat16, d)
            == T.WGMMA_PADDED_CP} == widths
    assert {d % 2 for d in bf16 if d % 8} == {0, 1}


def test_compare_kernels_times_the_padded_route_at_its_rows():
    """tools/compare_kernels times K1, K2 and K3 at bench.py's xl head dim
    160 (B2, and the xl16 train step's B8) and at chip_smoke.py's rows of
    the padded route (d 256, 80 and 192, at those rows' shapes), beside
    b1's shapes."""
    from ray_tpu_torch.tools.compare_kernels import SHAPES

    cs = _chip_smoke()
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    got = {(kernel, *rest[:6]) for _, kernel, *rest in SHAPES
           if rest[6] == "bfloat16"}
    names = {name for name, *_ in SHAPES}
    assert {"d160_fwd", "xl16_fwd", "d256_fwd", "d80_fwd",
            "d192_fwd"} <= names
    for kernel in ("fwd", "dq", "dkdv"):
        assert (kernel, 8, 2048, 2048, 16, 128, True) in got
        assert (kernel, 2, 2048, 2048, 16, 160, True) in got
        for row in ("xl16_train", "d256_ragged", "d80_sq_lt_sk",
                    "d192_noncausal"):
            assert (kernel, *bwd[row][:6]) in got, row


def test_chunked_route_is_built_dispatched_and_held_on_the_card():
    """Past 256: the sources are built, every C entry dispatches there
    before the per-head-dim kernels of either dtype (K1, K2 and K3 to
    their TMA-fed wgmma kernel before the cp.async-fed one), and the
    kernel phase holds K1, K2 and K3
    at 264, 320 and 512 in bf16 and at 320 in fp32, K1 and K2/K3 at B2
    S2048 H8 D512 too, and K1 at fp32 d 320 at that size, at d 384
    non-causal with Sq != Sk and at bf16 d 300 (the wgmma kernel fed by
    cp.async), all listed with the head-dim rows and timed in both dtypes
    by tools/compare_kernels."""
    from ray_tpu_torch.tools.compare_kernels import SHAPES

    assert {"flash_attn_dchunk_bwd_dq_cp_async.cu",
            "flash_attn_dchunk_bwd_dkdv_cp_async.cu",
            "flash_attn_dchunk_fma.cu", "flash_attn_dchunk_fwd_wgmma.cu",
            "flash_attn_dchunk_fwd_cp_async.cu"} <= set(T._SOURCES)
    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    fwd = (csrc / "flash_attn_fwd.cu").read_text()
    bwd = (csrc / "flash_attn_bwd.cu").read_text()
    assert fwd.index("rtt::fwd_dchunk_fma(") < fwd.index(
        "rtt::fwd_fma_ring(")
    assert fwd.index("rtt::fwd_dchunk_wgmma_cp_async(") < fwd.index(
        "launch_ws<64>(")
    assert fwd.index("rtt::fwd_dchunk_wgmma(") < fwd.index(
        "rtt::fwd_dchunk_wgmma_cp_async(")
    assert fwd.index("rtt::fwd_dchunk_fma(") < fwd.index(
        "rtt::fwd_dchunk_wgmma_cp_async(")
    for kernel, fp32 in (("dq", "fma("), ("dkdv", "fma_ring(")):
        assert bwd.index(f"rtt::bwd_{kernel}_dchunk_fma(") < bwd.index(
            f"rtt::bwd_{kernel}_{fp32}")
        assert bwd.index(f"rtt::bwd_{kernel}_dchunk_wgmma(") < bwd.index(
            f"rtt::bwd_{kernel}_dchunk_wgmma_cp_async(")
        assert bwd.index(f"rtt::bwd_{kernel}_dchunk_wgmma_cp_async(") < (
            bwd.index(f"rtt::bwd_{kernel}_{fp32}"))
    cs = _chip_smoke()
    fwd_rows = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    bwd_rows = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    want = {"d264": (264, "bfloat16"), "d320": (320, "bfloat16"),
            "d512": (512, "bfloat16"), "d320_f32": (320, "float32")}
    route = {"bfloat16": T.DCHUNK_WGMMA, "float32": T.DCHUNK_FMA}
    for name, (d, dtype) in want.items():
        assert fwd_rows[name] == (1, 1000, 4, d, True, dtype)
        assert bwd_rows[name] == (1, 1000, 1000, 4, d, True, dtype)
        assert name in cs.HEAD_DIM_SHAPES
        for kernel in ("fwd", "dq", "dkdv"):
            assert T.kernel_route(kernel, getattr(torch, dtype),
                                  d) == route[dtype]
    wide = {"d512_wide": (2, 2048, 8, 512, True, "bfloat16"),
            "d320_f32_wide": (2, 2048, 8, 320, True, "float32"),
            "d384_noncausal": (2, 1000, 8, 384, False, "bfloat16", 700),
            "d300": (1, 1000, 4, 300, True, "bfloat16")}
    for name, row in wide.items():
        assert fwd_rows[name] == row and name in cs.HEAD_DIM_SHAPES
    assert bwd_rows["d512_wide"] == (2, 2048, 2048, 8, 512, True,
                                     "bfloat16")
    assert T.kernel_route("fwd", torch.bfloat16, 384) == T.DCHUNK_WGMMA
    assert T.kernel_route("fwd", torch.bfloat16, 300) == T.DCHUNK_WGMMA_CP
    # compare_kernels: K1 at each of these rows in its dtype, parent and
    # new in one process
    timed = {(kernel, *rest) for _, kernel, *rest in SHAPES}
    for name in ("d264", "d320", "d512", "d320_f32", "d512_wide",
                 "d320_f32_wide", "d300"):
        b, s, h, d, causal, dtype = fwd_rows[name]
        assert ("fwd", b, s, s, h, d, causal, dtype) in timed, name
    assert {row[-1] for row in SHAPES} == {"bfloat16", "float32"}


def test_dchunk_wgmma_source_instantiates_each_slice_width_without_trap():
    """K1's wgmma kernel past 256 is launched at each slice width (the
    slice rounded up to 32: 160..256), with one or two consumer
    warpgroups and Q resident or streamed, for each feed; every wait is
    mbar_wait_no_trap (a trap keeps ptxas from allocating the consumers
    within setmaxnreg's count); the C++ rule for its head dims is the
    Python one."""
    src = (ROOT / "ray_tpu_torch" / "ops" / "csrc"
           / "flash_attn_dchunk_fwd_wgmma.cuh").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "__trap" not in code and "mbar_wait(" not in code
    assert "mbar_wait_no_trap(" in code
    widths = {int(w) for w in
              re.findall(r"integral_constant<int, (\d+)>", code)}
    assert widths == {160, 192, 224, 256}
    assert set(re.findall(r"launch_dw<SWP, (\d), (true|false), FEED>",
                          code)) == {
        ("1", "true"), ("2", "true"), ("2", "false")}
    routes = (ROOT / "ray_tpu_torch" / "ops" / "csrc"
              / "flash_attn_routes.cuh").read_text()
    assert ("return D > 256 && D % 8 == 0;" in routes)
    for d in (257, 264, 300, 320, 512, 520, 4096):
        assert (T.kernel_route("fwd", torch.bfloat16, d) == T.DCHUNK_WGMMA
                ) == (d > 256 and d % 8 == 0), d


@pytest.mark.parametrize("d,slices", [
    # D 264: two slices of 136 (padded to 160), not 256 + 8
    (264, [136, 128]),
    (320, [160, 160]),
    (512, [256, 256]),
    # D 520: three of 176, the last one short
    (520, [176, 176, 168]),
])
def test_dchunk_wgmma_slices_are_balanced_multiples_of_8(d, slices):
    """The bf16 kernel's slice plan (rtt::fwd_dchunk_wgmma): ceil(D / 256)
    slices of ceil(D / ns) rounded up to 8, the last one what is left."""
    ns = -(-d // 256)
    sw = (-(-d // ns) + 7) // 8 * 8
    got = [min(sw, d - c0) for c0 in range(0, d, sw)]
    assert got == slices and all(w % 8 == 0 for w in got)
    src = (ROOT / "ray_tpu_torch" / "ops" / "csrc"
           / "flash_attn_dchunk_fwd_wgmma.cuh").read_text()
    assert "const int sw = ((D + ns - 1) / ns + 7) / 8 * 8;" in src
    assert "(D + sw - 1) / sw)" in src


@pytest.mark.parametrize("kernel,shape,bound_ms,bound_by", [
    # B2 S2048 H8 D512 causal bf16: 68.7 GFLOP over 989 TFLOP/s
    ("fwd", (2, 2048, 2048, 8, 512, True, "bfloat16"), 0.0695,
     "operations"),
    # B2 S2048 H8 D320 causal fp32: 43.0 GFLOP over 67 TFLOP/s
    ("fwd", (2, 2048, 2048, 8, 320, True, "float32"), 0.6414,
     "operations"),
    ("dq", (2, 2048, 2048, 8, 512, True, "bfloat16"), 0.1043,
     "operations"),
    ("dkdv", (2, 2048, 2048, 8, 512, True, "bfloat16"), 0.1390,
     "operations"),
])
def test_attention_bound_at_the_wide_rows_past_256(kernel, shape, bound_ms,
                                                   bound_by):
    """The bounds chip_smoke.py reports, and PERF.md quotes, at the
    kernel phase's rows sized so that the arithmetic bounds them."""
    b, sq, sk, h, d, causal, dtype = shape
    got, by = _chip_smoke()._attention_work(kernel, b, sq, sk, h, d, causal,
                                            dtype)
    assert by == bound_by
    assert got == pytest.approx(bound_ms, abs=5e-5)


def test_check_head_dims_reports_the_kernels_past_256():
    """tools/check_head_dims prints a row per instantiation of K1's two
    kernels past 256 (their template arguments named), and runs K1 at
    shapes that reach each layout of the bf16 one: one and two consumer
    warpgroups, Q resident and streamed."""
    from ray_tpu_torch.tools.check_head_dims import WIDE_CASES, wgmma_rows

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123"
        "fwd_dchunk_wgmma_kernelILi256ELi2ELb1EEEv14CUtensorMap_st' for "
        "'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
        "fwd_ring_f32_kernelILi4ELi64ELi64ELi5ELi16ELb0ELb0EEEvPKfS2_S2_"
        "PfS3_iiiiif' for 'sm_90a'",
        "ptxas info    : Used 230 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ])
    rows = wgmma_rows(log)
    assert [r["kernel"] for r in rows] == [
        "fwd_dchunk_wgmma_kernel<256, 2, 1>",
        "fwd_ring_f32_kernel<4, 64, 64, 5, 16, 0, 0>"]
    assert [r["registers"] for r in rows] == [168, 230]
    # two consumer warpgroups need at least 132 blocks of 128 rows
    for dtype, d, (b, sq, _, h) in WIDE_CASES:
        if dtype == "bfloat16":
            sw = (-(-d // -(-d // 256)) + 7) // 8 * 8
            assert -(-sq // 128) * b * h * -(-d // sw) >= 132, d
    assert {d for dtype, d, _ in WIDE_CASES if dtype == "bfloat16"} >= {
        512, 640}
    assert {d % 4 == 0 for dtype, d, _ in WIDE_CASES
            if dtype == "float32"} == {True, False}


def test_b1_h4_is_served_through_the_wgmma_kernel_past_256():
    """chip_smoke.py serves b1's widths at 4 heads (head dim 512) as a
    phase of its own, its K1 launches held to the bf16 wgmma kernel past
    256."""
    cs = _chip_smoke()
    cfg = cs._text_config("b1_h4")
    assert cs._main_path_routes("bfloat16", cfg.head_dim)["fwd"] == (
        T.DCHUNK_WGMMA)
    assert "b1_h4" in cs.MODEL_DESC
    src = (ROOT / "chip_smoke.py").read_text()
    assert '("b1_h4_serve", lambda r: phase_serve(r, "b1_h4"))' in src


def _header_rules() -> dict:
    """The route constexprs of csrc/flash_attn_routes.cuh as Python
    functions of D: {name: rule}."""
    src = (ROOT / "ray_tpu_torch" / "ops" / "csrc"
           / "flash_attn_routes.cuh").read_text()
    rules = {}
    for name, body in re.findall(
            r"constexpr bool (\w+)\(int D\)\s*\{\s*return ([^;]+);\s*\}",
            src):
        expr = body.replace("&&", " and ").replace("||", " or ")
        rules[name] = eval(f"lambda D: {expr}")  # noqa: S307 -- our header
    return rules


@pytest.mark.parametrize("rule,kernel,route", [
    ("wgmma_padded_head_dim", "dq", T.WGMMA_PADDED),
    ("wgmma_padded_head_dim", "dkdv", T.WGMMA_PADDED),
    ("wgmma_padded_head_dim", "fwd", T.WGMMA_PADDED),
    ("wgmma_padded_cp_async_head_dim", "fwd", T.WGMMA_PADDED_CP),
    ("wgmma_padded_cp_async_head_dim", "dq", T.WGMMA_PADDED_CP),
    ("wgmma_padded_cp_async_head_dim", "dkdv", T.WGMMA_PADDED_CP),
    ("dchunk_wgmma_head_dim", "fwd", T.DCHUNK_WGMMA),
    ("dchunk_unaligned_head_dim", "fwd", T.DCHUNK_WGMMA_CP),
    ("dchunk_wgmma_head_dim", "dq", T.DCHUNK_WGMMA),
    ("dchunk_wgmma_head_dim", "dkdv", T.DCHUNK_WGMMA),
    ("dchunk_unaligned_head_dim", "dq", T.DCHUNK_WGMMA_CP),
    ("dchunk_unaligned_head_dim", "dkdv", T.DCHUNK_WGMMA_CP),
])
def test_route_table_is_the_headers_constexprs(rule, kernel, route):
    """attention.kernel_route in bf16 takes ``route`` at exactly the head
    dims the C dispatch's constexpr of the same route admits, and
    ``wgmma_padded_head_dim`` is the same rule in Python and in C."""
    rules = _header_rules()
    assert {"dchunk_head_dim", rule} <= set(rules)
    assert not {"fwd_padded_head_dim",
                "fwd_padded_cp_async_head_dim"} & set(rules)
    for d in range(1, 1100):
        got = T.kernel_route(kernel, torch.bfloat16, d) == route
        assert got == bool(rules[rule](d)), (rule, d)
        assert bool(rules["dchunk_head_dim"](d)) == (d > T.DCHUNK_PAST)
        assert bool(rules["wgmma_padded_head_dim"](d)) == (
            T.wgmma_padded_head_dim(d)), d


@pytest.mark.parametrize("header,sources,launch", [
    ("flash_attn_fwd_padded.cuh",
     {"flash_attn_fwd_padded.cu": "fwd_padded_feed<FEED_TMA>",
      "flash_attn_fwd_padded_cp_async.cu":
      "fwd_padded_feed<FEED_CP_ASYNC>"},
     r"launch_fwd_padded<DP, (\d), FEED>"),
    ("flash_attn_dchunk_fwd_wgmma.cuh",
     {"flash_attn_dchunk_fwd_wgmma.cu": "fwd_dchunk_feed<FEED_TMA>",
      "flash_attn_dchunk_fwd_cp_async.cu":
      "fwd_dchunk_feed<FEED_CP_ASYNC>"},
     r"launch_dw<SWP, (\d), (?:true|false), FEED>"),
])
def test_each_feed_is_instantiated_at_each_width_without_trap(
        header, sources, launch):
    """Each of K1's two wgmma kernels is one template whose producer is a
    parameter (TMA, or the warpgroup's own copies): one source a feed
    instantiates it at every width and both consumer-warpgroup counts,
    and nothing in the kernel, the feed helpers or the sources traps or
    waits through the trapping mbar_wait."""
    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    hdr = re.sub(r"//[^\n]*", "", (csrc / header).read_text())
    assert set(re.findall(launch, hdr)) == {"1", "2"}
    assert "int FEED>" in hdr and "feed_acquire<FEED>(" in hdr
    assert "fill_box<" in hdr and "fill_done(" in hdr
    for name, call in sources.items():
        assert name in T._SOURCES
        code = re.sub(r"//[^\n]*", "", (csrc / name).read_text())
        assert f'#include "{header}"' in code and call in code
        assert "__trap" not in code and "mbar_wait(" not in code
    assert "__trap" not in hdr and "mbar_wait(" not in hdr
    common = (csrc / "hopper_common.cuh").read_text()
    feed = common[common.index("constexpr int FEED_TMA"):]
    feed = re.sub(r"//[^\n]*", "", feed)
    assert "__trap" not in feed and "mbar_wait(" not in feed
    assert "cp.async.mbarrier.arrive.noinc" in feed
    assert "fence_proxy_async();" in feed


def test_no_source_names_a_removed_kernel():
    """The mma.sync kernels of K1, K2 and K3, the chunked fp32 K2 and K3
    kernels past 256 and the fp32 K1 and K3 up to 256 that the ring
    kernels replaced are gone: no source, build list or smoke list names
    them, no kernel source issues an mma.sync or ldmatrix instruction,
    every listed source exists, and every kernel source in csrc/ is
    listed; no bf16 route of K1, K2 or K3 at any head dim is one of the
    removed ones."""
    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    gone = ("flash_attn_fwd_mma.cu", "flash_fwd_mma_kernel", "fwd_mma(",
            "fwd_dchunk_mma", "rtt::fwd_mma", "bwd_dq_dchunk_f32_kernel",
            "bwd_dkdv_dchunk_f32_kernel", "flash_attn_dchunk.cu",
            "flash_attn_bwd_dq_mma.cu", "flash_attn_bwd_dkdv_mma.cu",
            "bwd_dq_mma(", "bwd_dkdv_mma(", "dchunk_mma(",
            "mma.sync.aligned", "ldmatrix", "flash_attn_fwd_fma.cu",
            "flash_fwd_f32_kernel", "rtt::fwd_fma(", "bwd_dkdv_f32_kernel",
            "bwd_dkdv_fma(", "flash_attn_dchunk_ring_f32.cuh",
            "fwd_dchunk_ring_f32_kernel", "bwd_dchunk_ring_f32_kernel")
    for path in csrc.iterdir():
        text = path.read_text()
        assert not [g for g in gone if g in text], path.name
    assert "flash_attn_fwd_mma.cu" not in T._SOURCES
    assert {p.name for p in csrc.glob("*.cu")} == set(T._SOURCES)
    assert {p.name for p in csrc.glob("*.cuh")} == set(T._HEADERS)
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not [g for g in gone if g in smoke]
    assert not hasattr(T, "MMA_SYNC") and not hasattr(T, "DCHUNK")
    routes = {T.kernel_route(kernel, torch.bfloat16, d)
              for kernel in ("fwd", "dq", "dkdv") for d in range(1, 601)}
    assert routes == {T.WGMMA, T.WGMMA_PADDED, T.WGMMA_PADDED_CP,
                      T.DCHUNK_WGMMA, T.DCHUNK_WGMMA_CP}
    assert not {"mma_sync", "dchunk"} & routes


@pytest.mark.parametrize("name,shape,bound_ms", [
    # B2 S2048 H8 D300 causal bf16: 2,098,176 kept pairs a head, 4 D
    # FLOPs a pair, 40.3 GFLOP over 989 TFLOP/s
    ("d300_wide", (2, 2048, 2048, 8, 300, True, "bfloat16"), 0.0407),
    # B2 S2048 H16 D100 causal bf16: 26.9 GFLOP
    ("d100_wide", (2, 2048, 2048, 16, 100, True, "bfloat16"), 0.02716),
])
def test_attention_bound_at_the_cp_async_rows(name, shape, bound_ms):
    """The kernel phase's wide rows of K1's cp.async-fed kernels, sized so
    that the arithmetic bounds them, and their bounds."""
    cs = _chip_smoke()
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    b, sq, sk, h, d, causal, dtype = shape
    assert fwd[name] == (b, sq, h, d, causal, dtype)
    assert name in cs.HEAD_DIM_SHAPES
    got, by = cs._attention_work("fwd", b, sq, sk, h, d, causal, dtype)
    assert by == "operations"
    assert got == pytest.approx(bound_ms, abs=5e-5)


def test_kernel_phase_and_compare_reach_every_new_route():
    """The kernel phase holds K1 on each new route (the padded kernel fed
    by TMA under 64, by cp.async at D % 4 == 0 and through registers at
    odd D; past 256 fed by cp.async and through registers), and
    tools/compare_kernels times K1 at d16_bf16, d20_ragged, d100_wide,
    d300 and d300_wide against the parent, each row at its kernel-phase
    shape."""
    from ray_tpu_torch.tools.compare_kernels import SHAPES

    cs = _chip_smoke()
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    assert fwd["d33_odd"] == (1, 1000, 4, 33, True, "bfloat16")
    assert fwd["d301"] == (1, 1000, 4, 301, True, "bfloat16")
    routes = {T.kernel_route("fwd", getattr(torch, r[5]), r[3])
              for r in fwd.values()}
    assert {T.WGMMA_PADDED_CP, T.DCHUNK_WGMMA_CP, T.WGMMA_PADDED} <= routes
    odd = {name for name, r in fwd.items() if r[5] == "bfloat16" and r[3] % 2}
    assert {"d33_odd", "d301"} <= odd
    assert all(name in cs.HEAD_DIM_SHAPES for name in
               ("d33_odd", "d301", "d100_wide", "d300_wide"))
    timed = {name: (kernel, *rest) for name, kernel, *rest in SHAPES}
    for row in ("d16_bf16", "d20_ragged", "d100_wide", "d300",
                "d300_wide"):
        b, s, h, d, causal, dtype, *sk = fwd[row]
        assert timed[f"{row}_fwd"] == (
            "fwd", b, s, sk[0] if sk else s, h, d, causal, dtype), row


def test_dchunk_bwd_wgmma_source_instantiates_each_slice_width_without_trap():
    """K2's and K3's wgmma kernel past 256 is one template (DKDV) in one
    header, instantiated by one source a kernel and feed, each every
    build compiles: K2 at dq's slice widths (160..256) with one or two
    consumer warpgroups, K3 at dk/dv's (96, 128) with one, each with its
    rows resident or streamed; no wait traps (a trap keeps ptxas from
    allocating the consumers within setmaxnreg's count), and the C
    dispatch takes it at the head dims the Python route table does."""
    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    header = "flash_attn_dchunk_bwd_wgmma.cuh"
    assert header in T._HEADERS
    code = re.sub(r"//[^\n]*", "", (csrc / header).read_text())
    assert "__trap" not in code and "mbar_wait(" not in code
    assert "mbar_wait_no_trap(" in code
    assert "launch_db<SWP, NCW, RES, DKDV, FEED>(" in code
    assert set(re.findall(r"take\((One|Two)\{\}, std::(true|false)_type",
                          code)) == {("One", "true"), ("Two", "true"),
                                     ("One", "false")}
    # K3 never takes two consumer warpgroups, nor K2 at 256 columns beside
    # a producer warpgroup that fills the boxes (its consumers' 224
    # registers spilled there)
    assert ("if constexpr (!DKDV && (FEED == FEED_TMA || SWP < 256)) {\n"
            "      if (blocks128 >= sm_count() &&") in code
    dkdv = code[code.index("if constexpr (DKDV) {\n    if (sw <= 96)"):]
    widths = {int(w) for w in
              re.findall(r"integral_constant<int, (\d+)>", dkdv)}
    assert widths == {96, 128, 160, 192, 224, 256}
    assert "dkdv ? 128 : 256" in code
    for kernel, flag in (("dq", "false"), ("dkdv", "true")):
        name = f"flash_attn_dchunk_bwd_{kernel}_wgmma.cu"
        assert name in T._SOURCES
        src = re.sub(r"//[^\n]*", "", (csrc / name).read_text())
        assert f'#include "{header}"' in src
        assert f"bwd_dchunk_feed<{flag}, FEED_TMA>(" in src
        assert "__trap" not in src and "mbar_wait(" not in src
    for d in (264, 300, 320, 512, 520, 4096):
        for kernel in ("dq", "dkdv"):
            assert (T.kernel_route(kernel, torch.bfloat16, d)
                    == T.DCHUNK_WGMMA) == (d % 8 == 0), (kernel, d)


def test_dchunk_bwd_ring_source_instantiates_each_width_and_copy_size():
    """K2's and K3's fp32 kernel past 256 is one template in the header
    K1's ring kernel shares (its ring copies and barrier), instantiated
    by one source a kernel at each slice width (3, 4 or 5 groups of 64
    columns, the rows streamed) and both copy sizes (16 bytes at D % 4 ==
    0, else 4); it sums on the CUDA cores alone (no mma, no tf32)."""
    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    header = "flash_attn_ring_f32.cuh"
    assert header in T._HEADERS
    code = re.sub(r"//[^\n]*", "", (csrc / header).read_text())
    past = code[code.index("cudaError_t dchunk_shape("):]
    past = past[:past.index("\n}\n")]
    assert set(re.findall(r"RingShape<4, 64, 64, (\d), 16, false>",
                          past)) == {"3", "4", "5"}
    assert "RF_MAX_SLICE = 320" in code
    assert "mma" not in code and "tf32" not in code.lower()
    assert "launch(std::true_type{})" in code and (
        "launch(std::false_type{})" in code)
    for kernel, flag in (("dq", "false"), ("dkdv", "true")):
        name = f"flash_attn_dchunk_bwd_{kernel}_fma.cu"
        assert name in T._SOURCES
        src = (csrc / name).read_text()
        assert f'#include "{header}"' in src
        assert "dchunk_shape(D," in src
        assert f"bwd_ring_at<decltype(shape), {flag}>(" in src
    k1 = (csrc / "flash_attn_dchunk_fma.cu").read_text()
    assert f'#include "{header}"' in k1 and "bwd_" not in re.sub(
        r"//[^\n]*", "", k1)
    assert "dchunk_shape(D," in k1 and "fwd_ring_at<" in k1


@pytest.mark.parametrize("d,dq,dkdv", [
    # D 264: dq two slices of 136 (padded to 160), dk/dv three of 88
    # (padded to 96)
    (264, [136, 128], [88, 88, 88]),
    (320, [160, 160], [112, 112, 96]),
    (512, [256, 256], [128, 128, 128, 128]),
    (520, [176, 176, 168], [104, 104, 104, 104, 104]),
])
def test_dchunk_bwd_slices_are_balanced_multiples_of_8(d, dq, dkdv):
    """K2's and K3's slice plan past 256 (bwd_dchunk_wgmma): ceil(D / W)
    slices of ceil(D / ns) rounded up to 8, W 256 for dq and 128 for dk
    and dv, the last slice what is left."""
    for most, want in ((256, dq), (128, dkdv)):
        ns = -(-d // most)
        sw = (-(-d // ns) + 7) // 8 * 8
        got = [min(sw, d - c0) for c0 in range(0, d, sw)]
        assert got == want and all(w % 8 == 0 and w <= most for w in got)
    src = (ROOT / "ray_tpu_torch" / "ops" / "csrc"
           / "flash_attn_dchunk_bwd_wgmma.cuh").read_text()
    assert "const int sw = ((D + ns - 1) / ns + 7) / 8 * 8;" in src
    assert "(D + sw - 1) / sw)" in src


def test_dchunk_bwd_layouts_fit_and_the_checks_reach_each():
    """The wgmma backward past 256 plans its rings on the host and refuses
    (launches nothing, returns an error) a layout over the H100's 227 KB;
    the C dispatch reports the layout it would launch through one export
    a kernel, and tools/check_head_dims reads it there: it fails unless
    its cases reach every (consumer warpgroups, rows resident) layout the
    dispatch instantiates and every head dim of the route to 4096 fits,
    and it prints the layouts at b1_h4's train step and d512_wide."""
    from ray_tpu_torch.tools import check_head_dims as chd

    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    code = re.sub(r"//[^\n]*", "",
                  (csrc / "flash_attn_dchunk_bwd_wgmma.cuh").read_text())
    assert "constexpr int DB_SMEM_MAX = 232448;" in code
    assert "if (alloc(nb, k, s) <= DB_SMEM_MAX) {" in code
    assert "if (!L::plan(nb, &kst, &sst)) return cudaErrorInvalidValue;" \
        in code
    assert ("if (!DbLayout<SWP, NCW, RES, DKDV>::plan(nb, &kst, &sst))\n"
            "          return cudaErrorInvalidValue;") in code
    assert ("const int chosen[7] = {SWP, sw, NCW, RES, kst, sst,\n"
            "                               feed_producers(FEED, NCW)};"
            ) in code
    assert len(chd._LAYOUT_KEYS) == 7 and chd.FEEDS == ("tma", "cp_async")
    for kernel, flag in (("dq", "false"), ("dkdv", "true")):
        for name, feed, export in (
                ("wgmma", "FEED_TMA", "dchunk_layout"),
                ("cp_async", "FEED_CP_ASYNC", "dchunk_cp_async_layout")):
            src = (csrc / f"flash_attn_dchunk_bwd_{kernel}_{name}.cu"
                   ).read_text()
            assert f"rtt_flash_attn_bwd_{kernel}_{export}(" in src
            assert f"bwd_dchunk_feed<{flag}, {feed}>(" in src and (
                "nullptr, layout);" in src)
    # what the dispatch instantiates: K2 at both consumer-warpgroup counts
    # (two only with its rows resident), K3 at one
    assert chd.LAYOUTS == {"dq": {(1, True), (2, True), (1, False)},
                           "dkdv": {(1, True), (1, False)}}
    tool = (ROOT / "ray_tpu_torch" / "tools"
            / "check_head_dims.py").read_text()
    assert "failed += not layouts[\"ok\"]" in tool
    assert "range(257, 4097)" in tool
    # the shapes whose layouts it prints are the kernel phase's rows
    fwd = {row[0]: row[1:] for row in _chip_smoke().KERNEL_SHAPES}
    for name, (b, sq, sk, h) in chd.LAYOUT_SHAPES.items():
        assert fwd[name][:4] == (b, sq, h, 512) and sq == sk, name
    cases = [(d, chd.SHAPE) for dtype, dims in chd.CASES
             if dtype == "bfloat16" for d in dims] + [
        (d, shape) for dtype, d, shape in chd.WIDE_CASES
        if dtype == "bfloat16"]
    assert {d for d, _ in cases if d > 256 and d % 8 == 0} >= {
        264, 320, 384, 448, 512, 576, 640, 704}


@pytest.mark.parametrize("kernel,bound_ms", [
    # b1's widths at 4 heads, B8 S2048 H4 D512 causal bf16: the same
    # B*H*D as b1's train shape, so its operation bounds
    ("fwd", 0.1390),
    ("dq", 0.2086),
    ("dkdv", 0.2781),
])
def test_attention_bound_at_the_b1_h4_train_shape(kernel, bound_ms):
    cs = _chip_smoke()
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    assert fwd["b1_h4_train"] == (8, 2048, 4, 512, True, "bfloat16")
    assert bwd["b1_h4_train"] == (8, 2048, 2048, 4, 512, True, "bfloat16")
    got, bound_by = cs._attention_work(kernel, 8, 2048, 2048, 4, 512, True,
                                       "bfloat16")
    assert bound_by == "operations"
    assert got == pytest.approx(bound_ms, abs=5e-5)


def test_b1_h4_train_path_is_b1_at_4_heads():
    """chip_smoke.py's b1_h4_train phase trains ModelConfig.b1's widths
    (hidden 2048, 24 layers, inter 5632) at 4 heads over 4 kv heads:
    head_dim 512, where K1, K2 and K3 all take the bf16 wgmma kernels
    past 256; its kernel rows run at the train step's attention shape,
    and the phase runs after xl16's."""
    import dataclasses

    cs = _chip_smoke()
    cfg = cs._text_config("b1_h4")
    b1 = cs._text_config("b1")
    assert dataclasses.replace(b1, heads=4, kv_heads=4) == cfg
    assert (cfg.hidden, cfg.layers, cfg.intermediate, cfg.vocab_size) == (
        2048, 24, 5632, 32000)
    assert (cfg.heads, cfg.kv_heads, cfg.head_dim) == (4, 4, 512)
    assert cfg.remat and cfg.dtype == torch.bfloat16
    assert cs._main_path_routes("bfloat16", cfg.head_dim) == {
        "fwd": T.DCHUNK_WGMMA, "dq": T.DCHUNK_WGMMA,
        "dkdv": T.DCHUNK_WGMMA}
    assert tuple(cs._train_batch("b1_h4").shape) == cs.TRAIN_TOKENS
    src = (ROOT / "chip_smoke.py").read_text()
    assert ('_text_train_phase(report, "b1_h4",\n'
            '                                                      '
            '"b1_h4_train")') in src
    assert src.index('("xl16", phase_xl16)') < src.index(
        '("b1_h4_train", phase_b1_h4_train)')


def test_kernel_phase_holds_the_backward_past_256_at_its_edges():
    """The kernel phase's backward rows past 256: fp32 d 320 at the size
    the forward has (B2 S2048 H8), d 384 non-causal with Sq 1000 > Sk
    700, d 320 causal with Sq 700 < Sk 1000 (key tiles no query reaches),
    and bf16 d 300 on the wgmma kernels fed by cp.async; each listed
    with the head-dim rows; tools/compare_kernels times K2 and K3 at the
    rows past 256 against the parent, each at its kernel-phase shape."""
    from ray_tpu_torch.tools.compare_kernels import SHAPES

    cs = _chip_smoke()
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    want = {
        "d320_f32_wide": ((2, 2048, 2048, 8, 320, True, "float32"),
                          T.DCHUNK_FMA),
        "d384_noncausal": ((2, 1000, 700, 8, 384, False, "bfloat16"),
                           T.DCHUNK_WGMMA),
        "d320_sq_lt_sk": ((1, 700, 1000, 4, 320, True, "bfloat16"),
                          T.DCHUNK_WGMMA),
        "d300": ((1, 1000, 1000, 4, 300, True, "bfloat16"),
                 T.DCHUNK_WGMMA_CP),
    }
    for name, (row, route) in want.items():
        assert bwd[name] == row and name in cs.HEAD_DIM_SHAPES, name
        for kernel in ("dq", "dkdv"):
            assert T.kernel_route(kernel, getattr(torch, row[-1]),
                                  row[4]) == route
    timed = {name: (kernel, *rest) for name, kernel, *rest in SHAPES}
    for name in ("d264", "d320", "d512", "d512_wide", "d320_f32",
                 "d320_f32_wide", "b1_h4_train"):
        for kernel in ("dq", "dkdv"):
            assert timed[f"{name}_{kernel}"] == (kernel, *bwd[name]), name


def test_check_head_dims_reports_the_backward_kernels_past_256():
    """tools/check_head_dims prints a row per instantiation of K2's and
    K3's kernels past 256 (their template arguments named)."""
    from ray_tpu_torch.tools.check_head_dims import wgmma_rows

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123"
        "bwd_dchunk_wgmma_kernelILi256ELi1ELb1ELb0EEEv14CUtensorMap_st' "
        "for 'sm_90a'",
        "ptxas info    : Used 250 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
        "bwd_ring_f32_kernelILi4ELi64ELi64ELi5ELi16ELb0ELb1ELb1EEEvPKfS2_"
        "S2_S2_S2_S2_PfS3_iiiiif' for 'sm_90a'",
        "ptxas info    : Used 240 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ])
    rows = wgmma_rows(log)
    assert [r["kernel"] for r in rows] == [
        "bwd_dchunk_wgmma_kernel<256, 1, 1, 0>",
        "bwd_ring_f32_kernel<4, 64, 64, 5, 16, 0, 1, 1>"]
    assert [r["registers"] for r in rows] == [250, 240]


@pytest.mark.parametrize("header,sources,launch", [
    # K2 up to 256: the d 64/128 kernel, every padded width at both
    # consumer-warpgroup counts for each feed
    ("flash_attn_bwd_dq_ws.cuh",
     {"flash_attn_bwd_dq_padded.cu": "bwd_dq_padded_feed<FEED_TMA>",
      "flash_attn_bwd_dq_padded_cp_async.cu":
      "bwd_dq_padded_feed<FEED_CP_ASYNC>"},
     r"launch_dq_ws<DP, false, FEED, (\d)>"),
    # K3 up to 256: its padded kernel at every width for each feed
    ("flash_attn_bwd_dkdv_padded.cuh",
     {"flash_attn_bwd_dkdv_padded.cu": "bwd_dkdv_padded_feed<FEED_TMA>",
      "flash_attn_bwd_dkdv_padded_cp_async.cu":
      "bwd_dkdv_padded_feed<FEED_CP_ASYNC>"},
     r"launch_dkdv_padded<(\d+), FEED>"),
    # K2 and K3 past 256: the slice kernel for each feed
    ("flash_attn_dchunk_bwd_wgmma.cuh",
     {"flash_attn_dchunk_bwd_dq_wgmma.cu": "bwd_dchunk_feed<false, FEED_TMA>",
      "flash_attn_dchunk_bwd_dkdv_wgmma.cu":
      "bwd_dchunk_feed<true, FEED_TMA>",
      "flash_attn_dchunk_bwd_dq_cp_async.cu":
      "bwd_dchunk_feed<false, FEED_CP_ASYNC>",
      "flash_attn_dchunk_bwd_dkdv_cp_async.cu":
      "bwd_dchunk_feed<true, FEED_CP_ASYNC>"},
     r"launch_db<SWP, NCW, RES, DKDV, (FEED)>"),
])
def test_backward_feeds_are_instantiated_on_both_sides_of_256(
        header, sources, launch):
    """K2's and K3's wgmma templates take what fills their boxes as a
    parameter, as K1's do: one source a feed instantiates each template
    with FEED_TMA or FEED_CP_ASYNC, up to 256 and past it; the boxes are
    filled by fill_box and fill_done where TMA cannot stride the rows,
    and a consumer fences after each wait on a full barrier; K3's stages,
    whose lse and delta rows stay 1-D TMA copies beside the producer
    threads' fills, count one arrival more; no new source traps."""
    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    assert header in T._HEADERS
    hdr = re.sub(r"//[^\n]*", "", (csrc / header).read_text())
    assert re.findall(launch, hdr)
    assert "int FEED>" in hdr or "int FEED, int NCW>" in hdr
    assert "fill_box<" in hdr and "fill_done(" in hdr
    assert "fence_proxy_async()" in hdr or "feed_acquire<FEED>(" in hdr
    assert "FEED == FEED_TMA ? 1 : FEED_THREADS" in hdr
    if "dkdv" in header:
        assert "FEED_THREADS + 1" in hdr
    elif "dchunk" in header:
        assert "fills + (FEED != FEED_TMA && DKDV ? 1 : 0)" in hdr
    for name, call in sources.items():
        assert name in T._SOURCES
        code = re.sub(r"//[^\n]*", "", (csrc / name).read_text())
        assert f'#include "{header}"' in code and call in code
        assert "__trap" not in code and "mbar_wait(" not in code
    # the padded kernels' widths: D rounded up to 32 from 32 to 256 (K2's
    # in its dispatch's switch, K3's in its launches)
    if "dchunk" not in header:
        widths = re.findall(launch if "dkdv" in header
                            else r"integral_constant<int, (\d+)>", hdr)
        assert {int(w) for w in widths} == {32, 64, 96, 128, 160, 192, 224,
                                            256}
    # the route each feed takes, on both sides of 256
    for d, route in ((20, T.WGMMA_PADDED_CP), (33, T.WGMMA_PADDED_CP),
                     (32, T.WGMMA_PADDED), (300, T.DCHUNK_WGMMA_CP),
                     (301, T.DCHUNK_WGMMA_CP), (320, T.DCHUNK_WGMMA)):
        for kernel in ("dq", "dkdv"):
            assert T.kernel_route(kernel, torch.bfloat16, d) == route


def test_k3_splits_its_products_at_one_box():
    """K3's padded kernel at D <= 64 (one 64-column box) gives warpgroup 0
    dV and warpgroup 1 dK over all DP columns, where past 64 they split
    the columns; its plan of columns at each width."""
    src = (ROOT / "ray_tpu_torch" / "ops" / "csrc"
           / "flash_attn_bwd_dkdv_padded.cuh").read_text()
    assert "static constexpr bool ONE_BOX = BOXES == 1;" in src
    assert ("ONE_BOX ? DP : BOXES == 3 ? DP - BOX_COLS : FIRST * BOX_COLS"
            in src)
    assert "const uint32_t a = wg == 0 ? pt : dst;" in src
    assert "store_pair_bf16((wg == 0 ? dv : dk) + o" in src


def test_entry_train_path_is_the_entry_model():
    """chip_smoke.py's entry_train phase trains the entry point's model
    (tools/multichip.py's ENTRY_MODEL, the JAX entry's config) at its
    full width, in bf16, remat off, at [16, 513] tokens (max_seq 512):
    head_dim 32, where K1, K2 and K3 all take the padded wgmma kernels fed
    by TMA; its kernel rows run at the step's attention shape (8 heads
    after the GQA repeat), compare_kernels times all three there, and the
    phase runs after b1_h4_train's."""
    from ray_tpu_torch.tools.compare_kernels import SHAPES
    from ray_tpu_torch.tools.multichip import ENTRY_MODEL

    cs = _chip_smoke()
    cfg = cs._text_config("entry")
    assert ENTRY_MODEL == dict(vocab_size=2048, hidden=256, layers=4,
                               heads=8, kv_heads=4, intermediate=704,
                               max_seq=512, remat=False)
    assert (cfg.vocab_size, cfg.hidden, cfg.layers, cfg.heads,
            cfg.kv_heads, cfg.intermediate, cfg.max_seq) == (
        2048, 256, 4, 8, 4, 704, 512)
    assert cfg.head_dim == 32 and not cfg.remat
    assert cfg.dtype == torch.bfloat16
    assert cs._main_path_routes("bfloat16", cfg.head_dim) == {
        "fwd": T.WGMMA_PADDED, "dq": T.WGMMA_PADDED,
        "dkdv": T.WGMMA_PADDED}
    assert cs.ENTRY_TRAIN_TOKENS == (16, cfg.max_seq + 1)
    assert tuple(cs._train_batch("entry").shape) == cs.ENTRY_TRAIN_TOKENS
    assert tuple(cs._train_batch("b1").shape) == cs.TRAIN_TOKENS
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    assert fwd["entry_train"] == (16, 512, 8, 32, True, "bfloat16")
    assert bwd["entry_train"] == (16, 512, 512, 8, 32, True, "bfloat16")
    assert "entry_train" in cs.HEAD_DIM_SHAPES and "entry" in cs.MODEL_DESC
    timed = {name: (kernel, *rest) for name, kernel, *rest in SHAPES}
    for kernel in ("fwd", "dq", "dkdv"):
        assert timed[f"entry_train_{kernel}"] == (kernel, *bwd["entry_train"])
    src = (ROOT / "chip_smoke.py").read_text()
    assert src.index('("b1_h4_train", phase_b1_h4_train)') < src.index(
        '("entry_train", phase_entry_train)')
    # remat off: K1 once a layer and step, not twice
    assert '"fwd": (2 if cfg.remat else 1) * cfg.layers * TRAIN_STEPS' in src


@pytest.mark.parametrize("kernel,bound_ms,bound_by", [
    # B16 S512 H8 D32 causal bf16: 131,328 kept pairs a head; at d 32
    # the bytes bound all three (each input read once: q, k, v, out, dO,
    # lse, delta, and the outputs written once, over 3.35 TB/s)
    ("fwd", 0.005086, "bytes"),
    ("dq", 0.006417, "bytes"),
    ("dkdv", 0.007669, "bytes"),
])
def test_attention_bound_at_the_entry_train_shape(kernel, bound_ms,
                                                  bound_by):
    got, by = _chip_smoke()._attention_work(kernel, 16, 512, 512, 8, 32,
                                            True, "bfloat16")
    assert by == bound_by
    assert got == pytest.approx(bound_ms, abs=5e-6)


def test_kernel_phase_and_compare_reach_each_route_k2_and_k3_left():
    """The backward rows where K2 and K3 left mma.sync: the kernel phase
    holds them at d 16 (TMA), 20 (Sq > Sk), 33 (odd), 100 at B2 S2048 H16,
    300 at both sizes and 301, each at the forward row's shape and listed
    with the head-dim rows, and compare_kernels times both kernels there
    against the parent, with the fp32 kernels at debug_f32."""
    from ray_tpu_torch.tools.compare_kernels import SHAPES

    cs = _chip_smoke()
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    timed = {name: (kernel, *rest) for name, kernel, *rest in SHAPES}
    want = {"d16_bf16": T.WGMMA_PADDED, "d20_ragged": T.WGMMA_PADDED_CP,
            "d33_odd": T.WGMMA_PADDED_CP, "d100_wide": T.WGMMA_PADDED_CP,
            "d300": T.DCHUNK_WGMMA_CP, "d300_wide": T.DCHUNK_WGMMA_CP,
            "d301": T.DCHUNK_WGMMA_CP}
    for name, route in want.items():
        b, sq, sk, h, d, causal, dtype = bwd[name]
        row = fwd[name]
        assert row[:6] == (b, sq, h, d, causal, dtype), name
        assert (row[6] if len(row) > 6 else sq) == sk, name
        assert name in cs.HEAD_DIM_SHAPES
        for kernel in ("dq", "dkdv"):
            assert T.kernel_route(kernel, torch.bfloat16, d) == route
            assert timed[f"{name}_{kernel}"] == (kernel, *bwd[name]), name
    for kernel in ("fwd", "dq", "dkdv"):
        assert timed[f"debug_f32_{kernel}"] == (kernel, *bwd["debug_f32"])


@pytest.mark.parametrize("d", [1, 16, 33, 64, 128, 255, 256])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkdv"])
def test_fp32_takes_the_ring_kernels_up_to_256(kernel, d):
    """In fp32 K1 and K3 take their ring kernels at every head dim up to
    256 (odd ones too) and K2 its FMA kernel; past 256 all three take the
    ring kernels' slices."""
    want = T.FMA if kernel == "dq" else T.FMA_RING
    assert T.kernel_route(kernel, torch.float32, d) == want
    assert T.kernel_route(kernel, torch.float32, d + 256) == T.DCHUNK_FMA


def test_fma_ring_rule_is_the_headers_constexpr():
    """The C dispatch sends fp32 K1 and K3 to the ring kernels at exactly
    the head dims attention.kernel_route names FMA_RING, after the past-256
    check; flash_attn_fwd.cu no longer calls the old FMA forward."""
    rule = _header_rules()["fma_ring_head_dim"]
    for d in range(1, 1100):
        for kernel in ("fwd", "dkdv"):
            got = T.kernel_route(kernel, torch.float32, d) == T.FMA_RING
            assert got == bool(rule(d)), (kernel, d)
    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    fwd = re.sub(r"//[^\n]*", "", (csrc / "flash_attn_fwd.cu").read_text())
    bwd = re.sub(r"//[^\n]*", "", (csrc / "flash_attn_bwd.cu").read_text())
    assert "rtt::fwd_fma(" not in fwd and "rtt::bwd_dkdv_fma(" not in bwd
    assert "rtt::fma_ring_head_dim(D) && dtype == 0" in fwd
    assert "rtt::fma_ring_head_dim(D) && dtype == 0" in bwd
    assert fwd.index("rtt::fwd_dchunk_fma(") < fwd.index(
        "rtt::fwd_fma_ring(")
    assert bwd.index("rtt::bwd_dkdv_dchunk_fma(") < bwd.index(
        "rtt::bwd_dkdv_fma_ring(")
    assert bwd.index("rtt::bwd_dq_dchunk_fma(") < bwd.index(
        "rtt::bwd_dq_fma(")


def _one_slice_shapes(code: str) -> list:
    """(largest D, RM, DK, CW, NCG, VK) of each branch of the header's
    one_slice_shape, in order, the last branch's D 256."""
    body = code[code.index("cudaError_t one_slice_shape("):]
    body = body[:body.index("\n}\n")]
    out = []
    for line in re.findall(r"(?:if \(D <= (\d+)\) )?return launch\("
                           r"RingShape<([^>]*)>", body.replace("\n", " ")):
        bound, args = line
        args = [a.strip() for a in args.split(",")]
        assert args[-1] == "true"  # the rows resident
        out.append((int(bound) if bound else 256, args[0],
                    *(int(a) for a in args[1:5])))
    return out


def test_ring_sources_instantiate_each_one_slice_width_and_copy_size():
    """Up to 256 K1's and K3's ring kernels run one slice a block: a
    source each (K1 flash_attn_fwd_fma_ring.cu, K3
    flash_attn_bwd_dkdv_fma_ring.cu) launches the shared header's kernel
    at each one-slice width -- the head dim rounded up to 16, 32 or 64
    under 64 (head-dim step and column group alike), to 64 from there --
    with the block's rows resident, and at both copy sizes (16 bytes at D
    % 4 == 0, else 4); 64 rows a block (8 a thread) up to 128 columns for
    K1 and 64 for K3, 32 past."""
    csrc = ROOT / "ray_tpu_torch" / "ops" / "csrc"
    header = "flash_attn_ring_f32.cuh"
    code = re.sub(r"//[^\n]*", "", (csrc / header).read_text())
    shapes = _one_slice_shapes(code)
    assert [(bound, dk, cw, ncg * cw) for bound, _, dk, cw, ncg, _
            in shapes] == [(16, 16, 16, 16), (32, 32, 32, 32),
                           (64, 64, 64, 64), (128, 64, 64, 128),
                           (192, 64, 64, 192), (256, 64, 64, 256)]
    assert all(64 % vk == 0 and vk * (ncg * cw + 4) <= 64 * (dk + 4)
               for _, _, dk, cw, ncg, vk in shapes)
    assert [rm for _, rm, *_ in shapes] == ["8", "8", "8", "RM128", "4",
                                            "4"]
    assert "constexpr int RM128 = WIDE_RM >= 128 ? 8 : 4;" in code
    assert "with_copy_size(D," in code
    widths = (16, 32, 64, 128, 192, 256)
    for d in range(1, 257):  # the narrowest width that holds d
        _, _, _, cw, ncg, _ = next(s for s in shapes if d <= s[0])
        assert ncg * cw == min(w for w in widths if w >= d), d
    for name, wide, call in (
            ("flash_attn_fwd_fma_ring.cu", 128,
             "fwd_ring_at<decltype(shape)>("),
            ("flash_attn_bwd_dkdv_fma_ring.cu", 64,
             "bwd_ring_at<decltype(shape), true>(")):
        assert name in T._SOURCES
        src = re.sub(r"//[^\n]*", "", (csrc / name).read_text())
        assert f'#include "{header}"' in src
        assert f"one_slice_shape<{wide}>(D," in src and call in src
        assert "if (!fma_ring_head_dim(D)) return cudaErrorInvalidValue;" \
            in src
    assert "mma" not in code and "tf32" not in code.lower()


@pytest.mark.parametrize("name,shape,bounds", [
    # B2 S2048 H16 causal fp32: 2,098,176 kept pairs a head, 2 D FLOPs a
    # pair and product (K1 2, K2 3, K3 4) over 67 TFLOP/s
    ("d16_f32_wide", (2, 2048, 2048, 16, 16, True, "float32"),
     (0.06413, 0.09620, 0.12827)),
    ("d128_f32_wide", (2, 2048, 2048, 16, 128, True, "float32"),
     (0.51307, 0.76960, 1.02613)),
])
def test_kernel_phase_and_compare_hold_the_fp32_wide_rows(name, shape,
                                                          bounds):
    """The kernel phase holds K1, K2 and K3 in fp32 at d 16 and 128 at a
    size where the arithmetic bounds them, listed with the head-dim rows,
    and compare_kernels times all three there, at debug_f32 and at the
    ragged fp32 rows against the parent."""
    from ray_tpu_torch.tools.compare_kernels import SHAPES

    cs = _chip_smoke()
    fwd = {row[0]: row[1:] for row in cs.KERNEL_SHAPES}
    bwd = {row[0]: row[1:] for row in cs.BWD_SHAPES}
    timed = {row[0]: row[1:] for row in SHAPES}
    b, sq, sk, h, d, causal, dtype = shape
    assert fwd[name] == (b, sq, h, d, causal, dtype)
    assert bwd[name] == shape and name in cs.HEAD_DIM_SHAPES
    for kernel, bound_ms in zip(("fwd", "dq", "dkdv"), bounds):
        assert timed[f"{name}_{kernel}"] == (kernel, *shape)
        got, by = cs._attention_work(kernel, b, sq, sk, h, d, causal, dtype)
        assert by == "operations"
        assert got == pytest.approx(bound_ms, abs=5e-5)
    for row in ("debug_f32", "ragged_f32"):
        assert {f"{row}_{k}" for k in ("fwd", "dq", "dkdv")} <= set(timed)
    assert timed["ragged_f32_dq"][1:] == bwd["ragged"]
    assert timed["ragged_f32_fwd"][1:4] == fwd["ragged"][:2] + (
        fwd["ragged"][1],)
