"""The port's ViT against the JAX package's, on the CPU.

``ViTConfig.debug()`` (32-px images, 8-px patches: 16 patches + CLS = 17
tokens, 4 heads of 16) in float32, with TF32 off: the JAX weights from
``ray_tpu.models.vision.init_params`` go through ``vit_params_from_jax``,
and both packages see the same numpy images and labels. The JAX side
takes its own CPU attention path, the port its plain blockwise versions.

Tolerances: ``patchify`` is a layout op and must be exact. ``_layer_norm``
within 2e-5 absolute and relative in float32 (summation order only);
in bfloat16 within two bf16 steps (2^-6 absolute and relative): XLA on
the CPU fuses the elementwise chain and rounds it once, where the port
rounds after each op as it is written (a first run saw 1.5e-2
relative, two steps at values near 2). Forward logits within 1e-4, the
loss within 1e-5 relative and its gradients within 1e-4, as the text model
(tests/test_torch_model.py). Three ClippedAdamW steps against optax on
the same gradients: parameters within 1e-5 absolute and 1e-4 relative
(each step's update feeds the next).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vision as jvit
from ray_tpu.models.training import make_optimizer as j_make_optimizer
from ray_tpu_torch.models import vision as tvit
from ray_tpu_torch.models.convert import vit_params_from_jax
from ray_tpu_torch.models.training import make_optimizer, tree_leaves

LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _setup(pool="cls", seed=0, batch=3):
    jcfg = jvit.ViTConfig.debug(pool=pool)
    tcfg = tvit.ViTConfig.debug(pool=pool)
    params = jvit.init_params(jcfg, jax.random.PRNGKey(seed))
    port = vit_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                               device="cpu")
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batch, jcfg.image_size, jcfg.image_size, jcfg.channels)
    ).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, size=batch).astype(np.int32)
    return jcfg, tcfg, params, port, images, labels


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _leaf_items(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree)
                for item in _leaf_items(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def test_patchify_matches_jax():
    cfg = tvit.ViTConfig.debug()
    images = np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    got = tvit.patchify(torch.from_numpy(images), cfg)
    want = jvit.patchify(jnp.asarray(images), jvit.ViTConfig.debug())
    assert tuple(got.shape) == (2, cfg.num_patches, 8 * 8 * 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 17, 64)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, jw = (jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    got = tvit._layer_norm(tx, tw, 1e-6)
    want = jvit._layer_norm(jx, jw, 1e-6)
    assert got.dtype == tx.dtype
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_forward_logits_match_jax(pool):
    jcfg, tcfg, params, port, images, _ = _setup(pool, seed=3)
    ref = np.asarray(jvit.forward(params, jnp.asarray(images), jcfg))
    with torch.no_grad():
        logits = tvit.forward(port, torch.from_numpy(images), tcfg)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (3, jcfg.num_classes)
    np.testing.assert_allclose(logits.numpy(), ref, **MODEL_TOL)


def _port_loss_and_grads(params, images, labels, cfg):
    items = _leaf_items(params)
    leaves = [p.requires_grad_() for _, p in items]
    loss = tvit.loss_fn(params, torch.from_numpy(images),
                        torch.from_numpy(labels), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip((name for name, _ in items), grads))


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_loss_fn_value_and_grads_match_jax(pool):
    jcfg, tcfg, params, port, images, labels = _setup(pool, seed=4)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jvit.loss_fn(p, jnp.asarray(images), jnp.asarray(labels),
                               jcfg))(params)
    loss, grads = _port_loss_and_grads(port, images, labels, tcfg)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    want = dict(_leaf_items(jax.tree.map(np.asarray, j_grads)))
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


def test_optimizer_steps_match_optax():
    """ClippedAdamW takes the ViT's parameters (blocks a list of dicts,
    walked by tree_leaves): 3 steps of loss_fn gradients and updates
    against jax.grad and optax from the same weights."""
    import optax

    jcfg, tcfg, params, port, images, labels = _setup(seed=5)
    j_opt = j_make_optimizer()
    j_state = j_opt.init(params)
    opt = make_optimizer()
    state = opt.init(port)
    names = [name for name, _ in _leaf_items(port)]
    for _ in range(3):
        j_grads = jax.grad(lambda p: jvit.loss_fn(
            p, jnp.asarray(images), jnp.asarray(labels), jcfg))(params)
        updates, j_state = j_opt.update(j_grads, j_state, params)
        params = optax.apply_updates(params, updates)
        leaves = [p.requires_grad_() for p in tree_leaves(port)]
        loss = tvit.loss_fn(port, torch.from_numpy(images),
                            torch.from_numpy(labels), tcfg)
        opt.update(port, torch.autograd.grad(loss, leaves), state)
    want = dict(_leaf_items(jax.tree.map(np.asarray, params)))
    for name, got in zip(names, tree_leaves(port)):
        np.testing.assert_allclose(got.detach().numpy(), want[name],
                                   err_msg=name, **STEP_TOL)
    assert state["count"] == 3 and len(state["mu"]) == len(names)


def test_vit_params_from_jax_carries_bf16_bits():
    """Every leaf, norms included, in cfg.dtype; blocks stay a list."""
    jcfg = jvit.ViTConfig(hidden=64, layers=2, heads=4, intermediate=128,
                          image_size=32, patch_size=8, num_classes=10)
    tcfg = tvit.ViTConfig(hidden=64, layers=2, heads=4, intermediate=128,
                          image_size=32, patch_size=8, num_classes=10)
    params_np = jax.tree.map(np.asarray,
                             jvit.init_params(jcfg, jax.random.PRNGKey(6)))
    port = vit_params_from_jax(params_np, tcfg, device="cpu")
    assert isinstance(port["blocks"], list) and len(port["blocks"]) == 2
    want = dict(_leaf_items(params_np))
    for name, leaf in _leaf_items(port):
        assert leaf.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                      want[name].view(np.int16))


def test_init_params_shapes_and_dtypes_follow_jax():
    got = dict(_leaf_items(tvit.init_params(
        tvit.ViTConfig.base(), torch.Generator().manual_seed(0),
        device="cpu")))
    want = dict(_leaf_items(jax.eval_shape(lambda: jvit.init_params(
        jvit.ViTConfig.base(), jax.random.PRNGKey(0)))))
    assert set(got) == set(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == spec.shape, name
        assert got[name].dtype == torch.bfloat16, name
    assert tvit.ViTConfig.base().num_patches + 1 == 197
    assert tvit.ViTConfig.base().head_dim == 64


@pytest.mark.parametrize("entry", ["init_params", "vit_params_from_jax"])
def test_vision_entry_points_raise_without_cuda(entry):
    """As the text model's entry points: None means CUDA, and a host
    without CUDA raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    cfg = tvit.ViTConfig.debug()
    calls = {"init_params": lambda: tvit.init_params(cfg),
             "vit_params_from_jax": lambda: vit_params_from_jax(
                 {"blocks": []}, cfg)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
