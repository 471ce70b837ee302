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


# -- loss and gradients --------------------------------------------------------
#
# Loss values within 1e-5 relative and gradients within 1e-4 absolute and
# relative (the JAX package's gradient tolerance, tests/test_model.py):
# the backward chains the whole stack's products in the reverse order, so
# fp32 rounding compounds further than in the forward logits.

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _leaf_items(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _port_loss_and_grads(params, tokens, cfg):
    leaves = [p.requires_grad_() for _, p in _leaf_items(params)]
    loss = ttfm.loss_fn(params, torch.from_numpy(tokens).long(), cfg)
    grads = torch.autograd.grad(loss, leaves)
    names = [name for name, _ in _leaf_items(params)]
    return loss.item(), dict(zip(names, grads))


def test_loss_fn_value_and_grads_match_jax():
    """ModelConfig.debug() (GQA, remat on in both): the port's loss_fn
    and its autograd gradients against jax.grad(tfm.loss_fn) on the
    same weights and tokens."""
    jcfg = jtfm.ModelConfig.debug()
    tcfg = ttfm.ModelConfig.debug()
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(4))
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(2, 65)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jnp.asarray(tokens), jcfg))(params)
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
    loss, grads = _port_loss_and_grads(port, tokens, tcfg)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    want = dict(_leaf_items(jax.tree.map(np.asarray, j_grads)))
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


def test_loss_fn_grads_match_jax_at_head_dim_160():
    """The CPU side of chip_smoke.py's xl16 path (bench.py's xl at 16
    heads, head_dim 160): the port's loss_fn gradients against jax.grad
    at a narrow config with that head dim (hidden 320, 2 heads over 1 kv
    head, 2 layers, vocab 256, fp32, remat on), seeded numpy tokens."""
    widths = dict(vocab_size=256, hidden=320, layers=2, heads=2, kv_heads=1,
                  intermediate=640, max_seq=64)
    jcfg = jtfm.ModelConfig(dtype=jnp.float32, **widths)
    tcfg = ttfm.ModelConfig(dtype=torch.float32, **widths)
    assert tcfg.head_dim == 160
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(5))
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(2, 49)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jnp.asarray(tokens), jcfg))(params)
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
    loss, grads = _port_loss_and_grads(port, tokens, tcfg)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    want = dict(_leaf_items(jax.tree.map(np.asarray, j_grads)))
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


def test_forward_logits_match_jax_at_head_dim_512():
    """The CPU side of chip_smoke.py's b1_h4 path (b1's widths at 4
    heads, head_dim 512, where K1 takes its wgmma kernel past 256 on the
    card): the port's forward logits against the JAX package's at a
    narrow config with that head dim (hidden 1024, 2 heads, 2 layers,
    vocab 256, fp32), seeded numpy tokens, weights carried by
    params_from_jax; within MODEL_TOL, fp32 summation order only."""
    widths = dict(vocab_size=256, hidden=1024, layers=2, heads=2, kv_heads=2,
                  intermediate=512, max_seq=64)
    jcfg = jtfm.ModelConfig(dtype=jnp.float32, remat=False, **widths)
    tcfg = ttfm.ModelConfig(dtype=torch.float32, **widths)
    assert tcfg.head_dim == 512
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(6))
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(2, 48)).astype(np.int32)
    ref = np.asarray(j_build_forward(jcfg)(params, jnp.asarray(tokens)))
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
    logits = build_forward(tcfg, device="cpu")(port, tokens)
    assert tuple(logits.shape) == (2, 48, 256)
    np.testing.assert_allclose(logits.numpy(), ref, **MODEL_TOL)


def test_chip_smoke_b1_h4_is_b1_at_4_heads():
    """chip_smoke.py's b1_h4 model is ModelConfig.b1() with 4 heads over 4
    kv heads (head_dim 512), every other width b1's."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = cs._text_config("b1_h4")
    assert (cfg.heads, cfg.kv_heads, cfg.head_dim) == (4, 4, 512)
    assert dataclasses.replace(cfg, heads=16, kv_heads=16) == (
        ttfm.ModelConfig.b1())


def _small(**kw):
    """The JAX twin tests' model (test_models_extra.py), fp32."""
    base = dict(vocab_size=128, hidden=64, layers=2, heads=4, kv_heads=4,
                intermediate=128, max_seq=64, dtype=torch.float32)
    base.update(kw)
    return ttfm.ModelConfig(**base)


def _small_params_and_tokens(batch):
    jcfg = jtfm.ModelConfig(vocab_size=128, hidden=64, layers=2, heads=4,
                            kv_heads=4, intermediate=128, max_seq=64,
                            dtype=jnp.float32)
    params = jax.tree.map(
        np.asarray, jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(batch).integers(0, 128, size=(batch, 33))
    return params, tokens


@pytest.mark.parametrize("policy", ["full", "dots", "off"])
def test_remat_policies_give_equal_grads(policy):
    """Remat is a scheduling choice only: "full", "dots" and no remat
    give the same loss and gradients (the port's twin of
    test_models_extra.py::test_dots_remat_policy_matches_full_remat)."""
    params, tokens = _small_params_and_tokens(2)
    base = _small(remat=False, logits_chunk=8)
    cfg = base if policy == "off" else _small(remat=True,
                                              remat_policy=policy,
                                              logits_chunk=8)
    l_ref, g_ref = _port_loss_and_grads(
        params_from_jax(params, base, device="cpu"), tokens, base)
    loss, grads = _port_loss_and_grads(
        params_from_jax(params, cfg, device="cpu"), tokens, cfg)
    np.testing.assert_allclose(loss, l_ref, rtol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat_policy"):
        ttfm.ModelConfig.debug(remat_policy="dot")


def test_chunked_cross_entropy_matches_plain(caplog):
    """logits_chunk runs the vocab projection per sequence chunk under
    checkpoint; value and gradients match the unchunked loss, and a chunk
    that does not divide the sequence warns and falls back (the port's
    twin of test_models_extra.py::test_chunked_cross_entropy_matches_plain).
    """
    params, tokens = _small_params_and_tokens(3)
    plain, chunked = _small(remat=False), _small(remat=False,
                                                 logits_chunk=8)
    l1, g1 = _port_loss_and_grads(
        params_from_jax(params, plain, device="cpu"), tokens, plain)
    l2, g2 = _port_loss_and_grads(
        params_from_jax(params, chunked, device="cpu"), tokens, chunked)
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    for name, g in g2.items():
        np.testing.assert_allclose(g.numpy(), g1[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    odd = _small(remat=False, logits_chunk=7)
    with caplog.at_level("WARNING"):
        l3, _ = _port_loss_and_grads(
            params_from_jax(params, odd, device="cpu"), tokens, odd)
    np.testing.assert_allclose(l3, l1, rtol=1e-6)
    assert "does not divide" in caplog.text


@pytest.mark.parametrize("name", ["debug", "tiny_moe", "vit_debug"])
def test_debug_configs_attention_takes_a_kernel_on_the_card(name):
    """The JAX package's test configs run on the card through the
    kernels: their head dim (hidden 64 over 4 heads, 16 as in the JAX
    package) takes the fp32 routes in their float32 (K1 and K3 the ring
    kernels, K2 the FMA kernel), and the wrapper's
    input checks pass at their attention shape (these raised for a CUDA
    tensor before every head dim up to 256 had a kernel)."""
    from ray_tpu.models import vision as jvit
    from ray_tpu_torch.models import vision as tvit
    from ray_tpu_torch.ops import attention as T

    if name == "vit_debug":
        cfg, jcfg = tvit.ViTConfig.debug(), jvit.ViTConfig.debug()
        seq = (cfg.image_size // cfg.patch_size) ** 2 + 1
    else:
        cfg = getattr(ttfm.ModelConfig, name)()
        jcfg = getattr(jtfm.ModelConfig, name)()
        seq = cfg.max_seq
    assert cfg.head_dim == jcfg.head_dim == 16
    assert cfg.dtype == torch.float32
    for kernel in ("fwd", "dq", "dkdv"):
        assert T.kernel_route(kernel, cfg.dtype, cfg.head_dim) == (
            T.FMA if kernel == "dq" else T.FMA_RING)
    q = torch.zeros((2, seq, cfg.heads, cfg.head_dim), dtype=cfg.dtype)
    T._check_kernel_inputs(q, q, q)
