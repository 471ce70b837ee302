"""Host-side logic around the hand-written flash-attention kernels, on the
CPU: which kernel each (kernel, dtype, head_dim) takes, the launch counts
by route, the input checks that raise before anything is built, and the
error a refused launch raises.

The kernels themselves run only on a card (chip_smoke.py holds each one
against its plain version there); nothing here builds or launches one.
"""

import pytest
import torch

from ray_tpu_torch.ops import attention as T


@pytest.mark.parametrize("kernel,dtype,head_dim,route", [
    # K1 and K3 in bf16 at head_dim 64 and 128: wgmma on TMA rings
    ("fwd", torch.bfloat16, 128, T.WGMMA),
    ("fwd", torch.bfloat16, 64, T.WGMMA),
    ("dkdv", torch.bfloat16, 128, T.WGMMA),
    ("dkdv", torch.bfloat16, 64, T.WGMMA),
    # a head_dim-32 row (64 bytes) is under the 128-byte swizzle box
    ("fwd", torch.bfloat16, 32, T.MMA_SYNC),
    ("dkdv", torch.bfloat16, 32, T.MMA_SYNC),
    # K2 keeps its mma.sync kernel at every head_dim
    ("dq", torch.bfloat16, 128, T.MMA_SYNC),
    ("dq", torch.bfloat16, 64, T.MMA_SYNC),
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
    """K3 copies dO and the lse rows by TMA: a misaligned dout or lse
    raises in the wrapper, before a kernel is built or launched."""
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
