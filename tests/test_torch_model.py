"""The port's dense transformer against the JAX package's, on the CPU.

Layers are compared one by one, then whole-model logits: the JAX
weights from ``ray_tpu.models.transformer.init_params`` go through
``ray_tpu_torch.models.convert.params_from_jax``, and both packages'
``build_forward`` see the same numpy tokens. Everything runs in float32.
TF32 is switched off for the comparison (it is off by default for
matmuls; set here so the claim does not rest on a default).

Tolerances: a single layer is within 2e-5 (the JAX package's forward
tolerance, different summation orders only). Whole-model logits are
within 1e-4 absolute and relative: fp32 rounding differences from the
two matmul libraries compound through every layer of the stack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu.models.training import build_forward as j_build_forward
from ray_tpu.ops import layers as jl
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.training import build_forward
from ray_tpu_torch.ops import layers as tl

LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    out = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    ref = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


def test_rope_frequencies_and_apply_rope():
    cos, sin = tl.rope_frequencies(32, 40, 10000.0)
    jcos, jsin = jl.rope_frequencies(32, 40, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **LAYER_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **LAYER_TOL)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 17, 3, 32)).astype(np.float32)
    for offset in (0, 5):
        out = tl.apply_rope(torch.from_numpy(x), cos, sin, offset)
        ref = jl.apply_rope(jnp.asarray(x), jcos, jsin, offset)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   **LAYER_TOL)


def test_swiglu():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    wg, wu = (rng.standard_normal((32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    out = tl.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    ref = jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


def _configs(name):
    """(JAX config, port config) with identical widths, fp32."""
    if name == "debug":  # GQA 4 query heads over 2 kv heads
        return (jtfm.ModelConfig.debug(remat=False),
                ttfm.ModelConfig.debug())
    # the __graft_entry__.entry() shape, in fp32
    widths = dict(vocab_size=2048, hidden=256, layers=4, heads=8,
                  kv_heads=4, intermediate=704, max_seq=512)
    return (jtfm.ModelConfig(dtype=jnp.float32, remat=False, **widths),
            ttfm.ModelConfig(dtype=torch.float32, **widths))


@pytest.mark.parametrize("name,seq", [("debug", 128), ("entry", 128),
                                      ("entry", 77)])
def test_forward_logits_match_jax(name, seq):
    jcfg, tcfg = _configs(name)
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(seq).integers(
        0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)
    ref = np.asarray(j_build_forward(jcfg)(params, jnp.asarray(tokens)))
    fwd = build_forward(tcfg, device="cpu")
    logits = fwd(params_from_jax(params_np, tcfg, device="cpu"), tokens)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (2, seq, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref, **MODEL_TOL)


def test_params_from_jax_carries_bf16_bits():
    """bfloat16 weights (the served type) convert bit for bit."""
    jcfg = dataclasses.replace(jtfm.ModelConfig.debug(remat=False),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(ttfm.ModelConfig.debug(),
                               dtype=torch.bfloat16)
    params_np = jax.tree.map(np.asarray,
                             jtfm.init_params(jcfg, jax.random.PRNGKey(3)))
    converted = params_from_jax(params_np, tcfg, device="cpu")
    wq = converted["layers"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        params_np["layers"]["wq"].view(np.int16))
    assert converted["final_norm"].dtype == torch.float32


def test_init_params_shapes_follow_jax():
    tcfg = ttfm.ModelConfig.debug()
    jcfg = jtfm.ModelConfig.debug(remat=False)
    got = ttfm.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    want = jax.eval_shape(lambda: jtfm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    for name in ("embed", "final_norm"):
        assert tuple(got[name].shape) == want[name].shape
    for name, spec in want["layers"].items():
        assert tuple(got["layers"][name].shape) == spec.shape, name
