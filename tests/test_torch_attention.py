"""The port's attention forward against the JAX package's, on the CPU.

``ray_tpu_torch.ops.attention.flash_attention`` takes its plain
blockwise path for CPU tensors; the JAX side runs its blockwise path and
its Pallas forward kernel in interpret mode. Inputs are made with numpy
from fixed seeds and handed to both. Everything is float32, and the
tolerance is the JAX package's own forward tolerance (atol = rtol =
2e-5, tests/test_model.py): the two sum in different orders, which moves
fp32 results in the last digits only.

The CUDA kernel itself runs only on a card: chip_smoke.py holds it
against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as A
from ray_tpu_torch.ops import attention as T

TOL = dict(atol=2e-5, rtol=2e-5)


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
    out, lse = T.flash_attention(*_torch(q, k, v), causal=causal)
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
    out, lse = T.flash_attention(*_torch(q, k, v), causal=causal,
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


def test_kernel_wrapper_needs_no_nvcc_to_import():
    """The module imports, and its plain path runs, on a host with no
    nvcc and no card: the kernel is built only when a CUDA tensor
    reaches it. Nothing counted a launch here."""
    q, k, v = _torch(*_qkv(3, 1, 8, 8, 1, 32))
    T.flash_attention(q, k, v)
    assert T.launches.count == 0
    assert T._lib is None
