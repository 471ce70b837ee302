"""The port's attention, forward and backward, against the JAX
package's, on the CPU.

``ray_tpu_torch.ops.attention`` takes its plain blockwise paths for CPU
tensors; the JAX side runs its blockwise paths and its Pallas kernels in
interpret mode. Inputs are made with numpy from fixed seeds and handed
to both. Everything is float32. Tolerances are the JAX package's own
(tests/test_model.py): 2e-5 for the forward; 1e-4 for gradients, which
chain three products and a difference (dp - delta) and so carry more
rounding; 2e-4 against the Pallas backward kernels, which round at their
own block boundaries (128 x 128 here, vs the blockwise path's 128-key
blocks).

The CUDA kernels themselves run only on a card: chip_smoke.py holds them
against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as A
from ray_tpu_torch.ops import attention as T

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
PALLAS_GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def _no_tf32():
    """Full-fp32 matmuls for the comparison (the default, set here so the
    tolerances do not rest on a default)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _qkv(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 64, 64, 4, 16),     # aligned
    (1, 200, 200, 2, 32),   # ragged: 200 is no multiple of the 128 block
    (2, 37, 300, 3, 8),     # Sq != Sk (top-left causal), ragged both
])
def test_plain_path_matches_jax(causal, shape):
    b, sq, sk, h, d = shape
    q, k, v = _qkv(sum(shape) + causal, b, sq, sk, h, d)
    scale = d ** -0.5
    out, lse = T._fwd_dispatch(*_torch(q, k, v), causal=causal)
    j_out = np.asarray(A.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    _, j_lse = A._blockwise_fwd(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, scale,
                                A.BLOCKWISE_BLOCK_K)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, h, sq)
    np.testing.assert_allclose(out.numpy(), j_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)
    ref = T.attention_reference(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    public = T.flash_attention(*_torch(q, k, v), causal=causal)
    assert torch.equal(public, out)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_path_matches_pallas_kernel_interpret(causal):
    """Against the TPU kernel itself, run through Pallas's interpreter,
    at S divisible by its blocks (the TPU kernel's own requirement)."""
    q, k, v = _qkv(11 + causal, 1, 256, 256, 2, 64)
    scale = 64 ** -0.5
    A._FORCE_INTERPRET = True
    try:
        j_out, j_lse = A._pallas_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, scale, 128,
                                     128)
    finally:
        A._FORCE_INTERPRET = False
    out, lse = T._fwd_dispatch(*_torch(q, k, v), causal=causal,
                               sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_path_matches_pallas_kernel_interpret_at_d160(causal):
    """The forward at bench.py's xl head dim at 16 heads (160: the padded
    wgmma route on the card, held there against this plain path) against
    the TPU kernel itself through Pallas's interpreter."""
    q, k, v = _qkv(13 + causal, 1, 256, 256, 2, 160)
    scale = 160 ** -0.5
    A._FORCE_INTERPRET = True
    try:
        j_out, j_lse = A._pallas_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, scale, 128,
                                     128)
    finally:
        A._FORCE_INTERPRET = False
    out, lse = T._fwd_dispatch(*_torch(q, k, v), causal=causal,
                               sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)


def test_attention_reference_matches_jax():
    q, k, v = _qkv(5, 2, 48, 48, 2, 16)
    for causal in (False, True):
        out = T.attention_reference(*_torch(q, k, v), causal=causal)
        ref = A.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _residuals(seed, b, sq, sk, h, d, causal):
    """q, k, v, dout (numpy) and the JAX forward's out and lse."""
    q, k, v = _qkv(seed, b, sq, sk, h, d)
    dout = np.random.default_rng(seed + 1).standard_normal(
        (b, sq, h, d)).astype(np.float32)
    out, lse = A._blockwise_fwd(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, d ** -0.5,
                                A.BLOCKWISE_BLOCK_K)
    return q, k, v, dout, np.array(out), np.array(lse)  # writable


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 64, 64, 4, 16),     # aligned
    (1, 200, 200, 2, 32),   # ragged: 200 is no multiple of the 128 block
    (2, 37, 300, 3, 8),     # Sq < Sk (top-left causal), ragged both
    (1, 300, 37, 2, 8),     # Sq > Sk
])
def test_blockwise_bwd_matches_jax(causal, shape):
    b, sq, sk, h, d = shape
    res = _residuals(sum(shape) + causal, b, sq, sk, h, d, causal)
    scale = d ** -0.5
    got = T._blockwise_bwd(*_torch(*res[:3]), *_torch(*res[4:]),
                           torch.from_numpy(res[3]), causal, scale)
    want = A._blockwise_bwd(*(jnp.asarray(x) for x in res[:3]),
                            jnp.asarray(res[4]), jnp.asarray(res[5]),
                            jnp.asarray(res[3]), causal, scale,
                            A.BLOCKWISE_BLOCK_K)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("d,causal", [
    (16, True),    # ModelConfig.debug / tiny_moe / ViTConfig.debug
    (20, False),   # a bf16 row of 40 bytes: the kernels' element-wise loads
    (80, True),    # an odd count of 16-wide head-dim steps
    (160, True),   # bench.py's xl width at 16 heads
    (256, False),  # the widest head dim a kernel takes
    # the padded wgmma route's other widths (D rounded up to 32): 72 ->
    # 96, 120 -> 128, 192, 224
    (72, True),
    (120, False),
    (192, True),
    (224, False),
    # the padded wgmma kernels fed through registers (an odd D under 64)
    # and by 8-byte cp.async (a row of 200 bytes)
    (33, True),
    (100, False),
])
def test_blockwise_fwd_bwd_match_jax_at_head_dims_off_64_and_128(d, causal):
    """The plain versions the padded wgmma and FMA kernels are
    held against on the card, against the JAX package's, at the head dims
    those routes take, ragged (Sq != Sk, neither a multiple of the
    128-key block)."""
    b, sq, sk, h = 1, 150, 97, 2
    q, k, v = _qkv(d + causal, b, sq, sk, h, d)
    scale = d ** -0.5
    out, lse = T._blockwise_fwd(*_torch(q, k, v), causal, scale)
    j_out, j_lse = A._blockwise_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, scale,
                                    A.BLOCKWISE_BLOCK_K)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)
    res = _residuals(d + causal + 1, b, sq, sk, h, d, causal)
    got = T._blockwise_bwd(*_torch(*res[:3]), *_torch(*res[4:]),
                           torch.from_numpy(res[3]), causal, scale)
    want = A._blockwise_bwd(*(jnp.asarray(x) for x in res[:3]),
                            jnp.asarray(res[4]), jnp.asarray(res[5]),
                            jnp.asarray(res[3]), causal, scale,
                            A.BLOCKWISE_BLOCK_K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


# bf16 out and grads: both sides accumulate in fp32 and round once to
# bf16, so they differ by up to a bf16 step (2^-8 relative) of values up to
# a few in magnitude; the lse stays fp32 on both
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [264, 320, 512, 300, 301])
def test_flash_attention_past_head_dim_256_matches_jax(d, dtype):
    """The plain versions the kernels past 256 are held against on the
    card take every head dim past 256: the port's flash_attention on the
    CPU, forward and grads, against the JAX package's flash_attention and
    jax.grad at [1, 128, 2, D] causal (the JAX blockwise path here). On
    the card K1, K2 and K3 take their wgmma kernels in bf16 (fed by TMA
    at D % 8 == 0, by cp.async at 300 and through registers at 301) and
    their ring-fed FMA kernels in fp32."""
    import jax

    rng = np.random.default_rng(d)
    q, k, v, g = (rng.standard_normal((1, 128, 2, d)).astype(np.float32)
                  for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    j_out, vjp = jax.vjp(lambda a, b, c: A.flash_attention(a, b, c, True),
                         jq, jk, jv)
    j_grads = vjp(jnp.asarray(g, jdt))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = T.flash_attention(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(g).to(tdt))
    tol = TOL if dtype == "float32" else BF16_TOL
    gtol = GRAD_TOL if dtype == "float32" else BF16_TOL
    k1 = (T.DCHUNK_FMA if dtype == "float32" else
          T.DCHUNK_WGMMA if d % 8 == 0 else T.DCHUNK_WGMMA_CP)
    assert out.dtype == tdt and T.kernel_route("fwd", tdt, d) == k1
    assert T.kernel_route("dq", tdt, d) == T.kernel_route(
        "dkdv", tdt, d) == k1
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(j_out, np.float32), **tol)
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **gtol)


@pytest.mark.parametrize("d,b,s,heads,kv_heads", [
    # ModelConfig.debug's attention: 4 heads over 2 kv heads, d 16, its
    # max_seq 128
    (16, 2, 128, 4, 2),
    # d 128, ragged (no multiple of the 128-key block), no GQA
    (128, 1, 150, 2, 2),
])
def test_flash_attention_fp32_ring_head_dims_match_jax(d, b, s, heads,
                                                        kv_heads):
    """The plain versions the fp32 kernels up to 256 are held against on
    the card (K1 and K3 on their ring kernels, K2 on FMA): the port's
    flash_attention on the CPU, forward and grads, against the JAX
    package's flash_attention and jax.vjp, causal, with k and v repeated
    from kv_heads to heads on both sides as the models do (jnp.repeat /
    torch.repeat_interleave on the head axis), so the grads reach the
    un-repeated k and v. Tolerances: TOL for the forward, GRAD_TOL for
    the grads (the module's, the JAX package's own)."""
    import jax

    rng = np.random.default_rng(1000 + d)
    q, g = (rng.standard_normal((b, s, heads, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, s, kv_heads, d)).astype(np.float32)
            for _ in range(2))
    rep = heads // kv_heads

    def j_attn(a, kk, vv):
        return A.flash_attention(a, jnp.repeat(kk, rep, axis=2),
                                 jnp.repeat(vv, rep, axis=2), True)

    j_out, vjp = jax.vjp(j_attn, *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = T.flash_attention(tq, tk.repeat_interleave(rep, dim=2),
                            tv.repeat_interleave(rep, dim=2), causal=True)
    out.backward(torch.from_numpy(g))
    assert T.kernel_route("fwd", torch.float32, d) == T.FMA_RING
    assert T.kernel_route("dkdv", torch.float32, d) == T.FMA_RING
    assert T.kernel_route("dq", torch.float32, d) == T.FMA
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)


@pytest.mark.parametrize("d", [20, 33, 48])
def test_flash_attention_bf16_grads_under_64_match_jax(d):
    """The head dims K2 and K3 took on mma.sync until they moved onto
    their padded wgmma kernels: 20 (fed by cp.async), 33 (through
    registers) and 48 (by TMA, one 64-column box). In bf16, the port's
    flash_attention on the CPU, forward and grads, against the JAX
    package's flash_attention and jax.vjp at [1, 128, 2, D] causal (the
    JAX blockwise path here), seeded numpy inputs."""
    import jax

    rng = np.random.default_rng(100 + d)
    q, k, v, g = (rng.standard_normal((1, 128, 2, d)).astype(np.float32)
                  for _ in range(4))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    j_out, vjp = jax.vjp(lambda a, b, c: A.flash_attention(a, b, c, True),
                         jq, jk, jv)
    j_grads = vjp(jnp.asarray(g, jnp.bfloat16))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    out = T.flash_attention(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    route = T.WGMMA_PADDED if d % 8 == 0 else T.WGMMA_PADDED_CP
    for kernel in ("fwd", "dq", "dkdv"):
        assert T.kernel_route(kernel, torch.bfloat16, d) == route
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(j_out, np.float32), **BF16_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_bwd_matches_pallas_kernels_interpret(causal, d):
    """Against the TPU dq and dk/dv kernels themselves, through Pallas's
    interpreter, at S divisible by their blocks."""
    q, k, v, dout, out, lse = _residuals(21 + d + causal, 1, 256, 256, 2,
                                         d, causal)
    scale = d ** -0.5
    A._FORCE_INTERPRET = True
    try:
        want = A._pallas_bwd(*(jnp.asarray(x) for x in (q, k, v, out, lse,
                                                        dout)),
                             causal, scale, 128, 128)
    finally:
        A._FORCE_INTERPRET = False
    got = T._bwd_dispatch(*_torch(q, k, v, out, lse, dout), causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **PALLAS_GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 48, 48, 2, 16), (1, 30, 70, 3, 8),
                                   (1, 70, 30, 2, 8)])
def test_flash_attention_grads_match_reference_autograd(causal, shape):
    """flash_attention is differentiable, and its backward (the plain
    blockwise one on the CPU) agrees with autograd through the O(S^2)
    reference."""
    b, sq, sk, h, d = shape
    q, k, v = _qkv(40 + sum(shape), b, sq, sk, h, d)
    dout = torch.from_numpy(np.random.default_rng(sq).standard_normal(
        (b, sq, h, d)).astype(np.float32))
    grads = []
    for fn in (T.flash_attention, T.attention_reference):
        args = [x.requires_grad_() for x in _torch(q, k, v)]
        out = fn(*args, causal=causal)
        grads.append(torch.autograd.grad(out, args, dout))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


def test_blockwise_attention_is_the_cpu_path():
    """blockwise_attention (the plain versions as an op, the kernels'
    yardstick on the card) is what flash_attention runs on the CPU."""
    q, k, v = _qkv(8, 1, 40, 40, 2, 16)
    grads = []
    for fn in (T.flash_attention, T.blockwise_attention):
        args = [x.requires_grad_() for x in _torch(q, k, v)]
        out = fn(*args)
        grads.append((out, *torch.autograd.grad(out.square().sum(), args)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_kernel_wrapper_needs_no_nvcc_to_import():
    """The module imports, and its plain paths run forward and backward,
    on a host with no nvcc and no card: the kernels are built only when a
    CUDA tensor reaches them. Nothing counted a launch here."""
    q, k, v = (x.requires_grad_() for x in _torch(*_qkv(3, 1, 8, 8, 1, 32)))
    T.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (T.launches.count, T.dq_launches.count,
            T.dkdv_launches.count) == (0, 0, 0)
    assert T._lib is None
