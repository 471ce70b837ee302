"""Host-side logic around the hand-written flash-attention kernels, on the
CPU: which kernel each (kernel, dtype, head_dim) takes, the launch counts
by route, the input checks that raise before anything is built, and the
error a refused launch raises.

The kernels themselves run only on a card (chip_smoke.py holds each one
against its plain version there); nothing here builds or launches one.
"""

import importlib.util
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
    # a head_dim-32 row (64 bytes) is under the 128-byte swizzle box
    ("fwd", torch.bfloat16, 32, T.MMA_SYNC),
    ("dkdv", torch.bfloat16, 32, T.MMA_SYNC),
    # K2 follows the same rule: wgmma at 64 and 128, mma.sync at 32
    ("dq", torch.bfloat16, 128, T.WGMMA),
    ("dq", torch.bfloat16, 64, T.WGMMA),
    ("dq", torch.bfloat16, 32, T.MMA_SYNC),
    # float32: exact FMAs for all three
    ("fwd", torch.float32, 128, T.FMA),
    ("dq", torch.float32, 64, T.FMA),
    ("dkdv", torch.float32, 32, T.FMA),
])
def test_kernel_route(kernel, dtype, head_dim, route):
    assert T.kernel_route(kernel, dtype, head_dim) == route


@pytest.mark.parametrize("kernel,dtype,head_dim,error", [
    ("fwd", torch.float16, 128, TypeError),
    ("dkdv", torch.bfloat16, 96, ValueError),
    ("fwd", torch.bfloat16, 256, ValueError),
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
    for route in (T.WGMMA, T.WGMMA, T.MMA_SYNC):
        count.add(route)
    assert count.count == 3
    seen = count.by_route
    assert seen == {T.WGMMA: 2, T.MMA_SYNC: 1}
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
    offset of a tile's lse/delta rows off a 16-byte boundary), K2 beside
    it, and ViT-B/16's train shape; without CUDA it exits 2."""
    from ray_tpu_torch.tools import check_bwd_rows

    k3 = {s % 4 for kernel, _, s, *_ in check_bwd_rows.CASES
          if kernel == "dkdv"}
    assert k3 == {0, 1, 2, 3}
    assert {c[0] for c in check_bwd_rows.CASES} == {"dq", "dkdv"}
    assert ("dkdv", 128, 197, 12, 64, False) in check_bwd_rows.CASES
    if not torch.cuda.is_available():
        assert check_bwd_rows.main([]) == 2
