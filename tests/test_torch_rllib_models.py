"""The port's RLlib model catalog (ray_tpu_torch/rllib/models.py) against
the JAX package's (ray_tpu/rllib/models.py) on the CPU: the same
parameters (the JAX ``init``'s, as numpy) through both ``apply``s.

- ``fcnet`` and ``gru_net`` (its cell has no hidden bias; ``lax.scan``
  is a loop over time);
- ``vision_net`` at 84×84×4 (the catalog's default filters) and at odd
  sizes (83×83, 7×9), where XLA's SAME padding is asymmetric; the NHWC
  flatten before ``fc``;
- the gradient of a loss through ``vision_net`` and ``gru_net``;
- ``ModelCatalog``'s dispatch and the port's ``init`` trees (keys and
  shapes equal to the JAX package's); ``init`` without a device raises
  on a host without CUDA.

Tolerance: float32 on both sides, apart by summation order (XLA's conv
and dot vs ATen's), rel L2 OUT_REL_L2 on outputs and GRAD_REL_L2 on
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import models as jm
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib.policy import tree_leaves, tree_map, tree_to_device

OUT_REL_L2 = 1e-5
GRAD_REL_L2 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """RLlib runs thousands of tiny torch ops; with the test runner's
    worker processes side by side, torch's intra-op thread pools
    oversubscribe the cores and spin (4x slower under -n 4)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(got, want):
    want = np.asarray(want)
    return float(np.linalg.norm(np.asarray(got) - want)
                 / max(np.linalg.norm(want), 1e-12))


def _pair(jmodel, tmodel, seed=0):
    """JAX params (numpy) and the same values as port tensors."""
    jparams = jax.device_get(jmodel[0](jax.random.PRNGKey(seed)))
    return jparams, tree_to_device(jparams, "cpu")


def _shapes(tree):
    return tree_map(lambda x: tuple(np.shape(x)), tree)


def test_fcnet():
    sizes = (6, 32, 16, 3)
    jmodel, tmodel = jm.fcnet(sizes), tm.fcnet(sizes)
    jp, tp = _pair(jmodel, tmodel)
    x = np.random.default_rng(0).normal(size=(10, 6)).astype(np.float32)
    got = tmodel[1](tp, torch.as_tensor(x)).detach().numpy()
    assert got.shape == (10, 3)
    assert _rel_l2(got, jmodel[1](jp, jnp.asarray(x))) < OUT_REL_L2
    tparams = tmodel[0](torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(tm_numpy(tparams)) == _shapes(jp)


def tm_numpy(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


@pytest.mark.parametrize("shape", [(84, 84, 4), (83, 83, 3), (7, 9, 2)])
def test_vision_net(shape):
    """Odd sizes pad asymmetrically (XLA's SAME: the extra row or column
    after), so a symmetric pad or a flatten in NCHW order fails here."""
    jmodel, tmodel = jm.vision_net(shape, 5), tm.vision_net(shape, 5)
    jp, tp = _pair(jmodel, tmodel, seed=1)
    x = np.random.default_rng(1).uniform(
        size=(3, *shape)).astype(np.float32)
    got = tmodel[1](tp, torch.as_tensor(x)).detach().numpy()
    assert got.shape == (3, 5)
    assert _rel_l2(got, jmodel[1](jp, jnp.asarray(x))) < OUT_REL_L2
    tparams = tmodel[0](torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(tm_numpy(tparams)) == _shapes(jp)


@pytest.mark.parametrize("size,kernel,stride", [
    (84, 4, 2), (83, 4, 2), (7, 3, 1), (9, 4, 2), (5, 8, 3), (1, 3, 2)])
def test_same_padding_matches_xla(size, kernel, stride):
    """The port's pad pair against lax's own SAME rule."""
    (want,) = jax.lax.padtype_to_pads((size,), (kernel,), (stride,),
                                      "SAME")
    assert tm.same_padding(size, kernel, stride) == tuple(want)


def _loss_grads_jax(apply, params, x, target):
    def loss(p):
        out = apply(p, x)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.mean((out - target) ** 2)

    return jax.device_get(jax.grad(loss)(params))


def _loss_grads_port(apply, params, x, target):
    out = apply(params, torch.as_tensor(x))
    out = out[0] if isinstance(out, tuple) else out
    loss = torch.mean((out - torch.as_tensor(target)) ** 2)
    leaves = tree_leaves(params)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return tree_map(lambda p: grads[id(p)].numpy(), params)


@pytest.mark.parametrize("family", ["vision", "gru"])
def test_gradients_match_jax(family):
    rng = np.random.default_rng(2)
    if family == "vision":
        jmodel, tmodel = (jm.vision_net((13, 11, 3), 4),
                          tm.vision_net((13, 11, 3), 4))
        x = rng.uniform(size=(4, 13, 11, 3)).astype(np.float32)
        target = rng.normal(size=(4, 4)).astype(np.float32)
    else:
        jmodel, tmodel = jm.gru_net(5, 8, 3), tm.gru_net(5, 8, 3)
        x = rng.normal(size=(4, 6, 5)).astype(np.float32)
        target = rng.normal(size=(4, 6, 3)).astype(np.float32)
    jp, tp = _pair(jmodel, tmodel, seed=2)
    want = _loss_grads_jax(jmodel[1], jp, jnp.asarray(x), target)
    got = _loss_grads_port(tmodel[1], tp, x, target)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == np.shape(w)
        assert _rel_l2(g, w) < GRAD_REL_L2


def test_gru_net_scan_recurrence():
    jmodel, tmodel = jm.gru_net(5, 16, 3), tm.gru_net(5, 16, 3)
    jp, tp = _pair(jmodel, tmodel, seed=3)
    x = np.random.default_rng(3).normal(size=(2, 7, 5)).astype(np.float32)
    out, h = tmodel[1](tp, torch.as_tensor(x))
    jout, jh = jmodel[1](jp, jnp.asarray(x))
    assert out.shape == (2, 7, 3) and h.shape == (2, 16)
    assert _rel_l2(out.detach().numpy(), jout) < OUT_REL_L2
    assert _rel_l2(h.detach().numpy(), jh) < OUT_REL_L2
    # carrying the hidden state across two halves == one pass
    o1, h1 = tmodel[1](tp, torch.as_tensor(x[:, :3]))
    o2, h2 = tmodel[1](tp, torch.as_tensor(x[:, 3:]), h_init=h1)
    np.testing.assert_allclose(
        torch.cat([o1, o2], dim=1).detach().numpy(),
        out.detach().numpy(), rtol=1e-6, atol=1e-6)
    # an explicit initial state goes through both packages alike
    h0 = np.random.default_rng(4).normal(size=(2, 16)).astype(np.float32)
    out, _ = tmodel[1](tp, torch.as_tensor(x), h_init=torch.as_tensor(h0))
    jout, _ = jmodel[1](jp, jnp.asarray(x), h_init=jnp.asarray(h0))
    assert _rel_l2(out.detach().numpy(), jout) < OUT_REL_L2
    tparams = tmodel[0](torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(tm_numpy(tparams)) == _shapes(jp)


def test_catalog_dispatch():
    cases = [((84, 84, 4), {}), ((8,), {}),
             ((8,), {"use_rnn": True, "rnn_hidden": 12}),
             ((8,), {"fcnet_hiddens": (7, 5)}),
             ((20, 20, 3), {"conv_filters": ((4, 3, 2), (8, 3, 2)),
                            "post_fcnet_hiddens": 16})]
    for obs_shape, config in cases:
        jinit, _ = jm.ModelCatalog.get_model(obs_shape, 3, config)
        tinit, _ = tm.ModelCatalog.get_model(obs_shape, 3, config)
        want = _shapes(jax.device_get(jinit(jax.random.PRNGKey(0))))
        got = _shapes(tm_numpy(tinit(torch.Generator().manual_seed(0),
                                     device="cpu")))
        assert got == want, (obs_shape, config)


def test_model_init_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    init, _ = tm.fcnet((4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init(torch.Generator().manual_seed(0))
