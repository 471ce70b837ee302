"""The port's optimizer and train step against the JAX package's, on the
CPU, in float32.

- ``make_optimizer()`` fed the same numpy gradients as optax's
  ``make_optimizer()`` for 3 updates: parameters and moments within
  1e-6 absolute and 1e-5 relative (the same elementwise arithmetic, apart
  only in the summation order of the global norm and in the last bit of
  a pow or sqrt).
- 3 steps of ``build_train_step`` for ``ModelConfig.debug()``, for it
  at hidden 640 over 2 heads (head dim 320, past the per-head-dim
  kernels' 256), and for the entry point's model (tools/multichip.py's
  ENTRY_MODEL, head dim 32, in float32), against the JAX
  ``build_train_step`` on a one-device
  mesh, from the same weights and tokens: loss and grad norm per step
  within 1e-4 relative (the gradient tolerance of tests/test_model.py;
  each step's update feeds the next, so the steps compound it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu.models.training import build_train_step as j_build_train_step
from ray_tpu.models.training import make_optimizer as j_make_optimizer
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.training import (
    build_train_step,
    make_optimizer,
    tree_leaves,
)
from ray_tpu_torch.tools.multichip import ENTRY_MODEL

OPT_TOL = dict(atol=1e-6, rtol=1e-5)
STEP_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_optimizer_matches_optax(grad_scale):
    """Both sides of the clip: small grads pass unclipped, large ones
    are scaled to the clip norm."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": {"c": (4,), "d": (2, 2, 2)}}
    params_np = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    grads_np = [jax.tree.map(
        lambda s: (rng.standard_normal(s) * grad_scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]

    j_opt = j_make_optimizer()
    j_params = jax.tree.map(jnp.asarray, params_np)
    j_state = j_opt.init(j_params)
    opt = make_optimizer()
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params_np)
    state = opt.init(params)
    for g_np in grads_np:
        updates, j_state = j_opt.update(jax.tree.map(jnp.asarray, g_np),
                                        j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        norm = opt.update(params, [torch.from_numpy(g) for g in
                                   jax.tree.leaves(g_np)], state)
        np.testing.assert_allclose(
            norm.item(), float(optax.global_norm(g_np)), rtol=1e-6)
        for got, want in zip(tree_leaves(params), jax.tree.leaves(j_params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **OPT_TOL)
    adam = j_state[1][0]
    for got, want in zip(state["mu"] + state["nu"],
                         jax.tree.leaves(adam.mu) + jax.tree.leaves(adam.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPT_TOL)
    assert state["count"] == int(adam.count) == 3


# ModelConfig.debug()'s fields changed in both packages: its own, head
# dim 320 (the attention past 256 on the CPU's plain versions), and the
# entry point's model (head dim 32, which chip_smoke.py trains on the
# card), float32 as the debug config is
CONFIGS = {"debug": {}, "d320": dict(hidden=640, heads=2, kv_heads=2),
           "entry": ENTRY_MODEL}
HEAD_DIMS = {"debug": 16, "d320": 320, "entry": 32}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_train_steps_match_jax(config):
    jcfg = dataclasses.replace(jtfm.ModelConfig.debug(), **CONFIGS[config])
    tcfg = dataclasses.replace(ttfm.ModelConfig.debug(), **CONFIGS[config])
    assert jcfg.head_dim == tcfg.head_dim == HEAD_DIMS[config]
    mesh = build_mesh(MeshSpec(dp=1, pp=1, sp=1, tp=1))
    j_step, j_init = j_build_train_step(jcfg, mesh)
    j_params, j_state = j_init(jax.random.PRNGKey(0))
    step, _ = build_train_step(tcfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), tcfg,
                             device="cpu")
    opt_state = make_optimizer().init(params)
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, size=(4, 33)).astype(np.int32)
    losses = []
    for _ in range(3):
        j_params, j_state, j_m = j_step(j_params, j_state,
                                        jnp.asarray(tokens))
        params, opt_state, m = step(params, opt_state, tokens)
        np.testing.assert_allclose(m["loss"].item(), float(j_m["loss"]),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(j_m["grad_norm"]), rtol=STEP_RTOL)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]
    assert opt_state["count"] == 3


def test_init_fn_draws_from_the_generator():
    step, init_fn = build_train_step(ttfm.ModelConfig.debug(), device="cpu")
    a, state = init_fn(torch.Generator().manual_seed(1))
    b, _ = init_fn(torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert len(state["mu"]) == len(tree_leaves(a)) and state["count"] == 0
