"""The port's MoE layers against the JAX package's, on the CPU.

``ModelConfig.tiny_moe`` (4 experts, top-2, every second layer sparse)
in float32, with TF32 off: the JAX weights from
``ray_tpu.models.transformer.init_params`` go through
``params_from_jax``, and both packages see the same numpy inputs.

Tolerances: ``moe_layer`` and ``_moe_tokens`` (out and aux) within 2e-5
absolute and relative, as a single dense layer (summation order only:
the routing, the capacity positions and the one-hot products are exact
in fp32). Whole-model logits within 1e-4; the loss within 1e-5 relative
and its gradients within 1e-4, as for the dense model
(tests/test_torch_model.py). Three train steps: loss and grad norm per
step within 1e-4 relative, as tests/test_torch_training.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu.models.training import build_forward as j_build_forward
from ray_tpu.models.training import build_train_step as j_build_train_step
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.training import (
    build_forward,
    build_train_step,
    make_optimizer,
    tree_leaves,
)

LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _configs(**kw):
    """(JAX config, port config) for tiny_moe with the same options."""
    return jtfm.ModelConfig.tiny_moe(**kw), ttfm.ModelConfig.tiny_moe(**kw)


def _weights(jcfg, tcfg, seed=0):
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")


def _layer(tree, i):
    """Layer i of a stacked (possibly nested) layer dict."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _leaf_items(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("group", [0, 32])
def test_moe_layer_matches_jax(group):
    """Output and aux loss of one MoE layer; group 32 routes the 64
    tokens in two checkpointed groups and averages their aux."""
    jcfg, tcfg = _configs(moe_group_size=group)
    params, port = _weights(jcfg, tcfg)
    x = np.random.default_rng(1).standard_normal((2, 32, 64)).astype(
        np.float32)
    j_out, j_aux = jtfm.moe_layer(jnp.asarray(x),
                                  _layer(params["layers"]["moe"], 1), jcfg)
    out, aux = ttfm.moe_layer(torch.from_numpy(x),
                              _layer(port["layers"]["moe"], 1), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **LAYER_TOL)
    np.testing.assert_allclose(aux.item(), float(j_aux), **LAYER_TOL)


@pytest.mark.parametrize("tokens,capacity_factor", [(40, 1.25), (40, 0.5)])
def test_moe_tokens_matches_jax(tokens, capacity_factor):
    """One token set, with capacity to spare and with half the choices
    dropped past capacity (keep, the clipped positions)."""
    jcfg, tcfg = _configs(capacity_factor=capacity_factor)
    params, port = _weights(jcfg, tcfg, seed=2)
    x = np.random.default_rng(tokens).standard_normal(
        (tokens, 64)).astype(np.float32)
    j_out, j_aux = jtfm._moe_tokens(jnp.asarray(x),
                                    _layer(params["layers"]["moe"], 0), jcfg)
    out, aux = ttfm._moe_tokens(torch.from_numpy(x),
                                _layer(port["layers"]["moe"], 0), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **LAYER_TOL)
    np.testing.assert_allclose(aux.item(), float(j_aux), **LAYER_TOL)


def test_non_dividing_group_falls_back_with_warning(caplog):
    """A group size that does not divide the tokens warns and routes them
    ungrouped, as the JAX package does."""
    _, plain = _configs()
    jcfg, odd = _configs(moe_group_size=24)
    _, port = _weights(jcfg, odd)
    moe = _layer(port["layers"]["moe"], 1)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 64)).astype(np.float32))
    with caplog.at_level("WARNING"):
        out, aux = ttfm.moe_layer(x, moe, odd)
    assert "does not divide token count 64" in caplog.text
    want, want_aux = ttfm.moe_layer(x, moe, plain)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


@pytest.mark.parametrize("group", [0, 32])
def test_forward_logits_match_jax(group):
    jcfg, tcfg = _configs(moe_group_size=group, remat=False)
    params, port = _weights(jcfg, tcfg)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    ref = np.asarray(j_build_forward(jcfg)(params, jnp.asarray(tokens)))
    logits = build_forward(tcfg, device="cpu")(port, tokens)
    assert tuple(logits.shape) == (2, 32, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref, **MODEL_TOL)


def _port_loss_and_grads(params, tokens, cfg):
    items = _leaf_items(params)
    leaves = [p.requires_grad_() for _, p in items]
    loss = ttfm.loss_fn(params, torch.from_numpy(tokens).long(), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip((name for name, _ in items), grads))


@pytest.mark.parametrize("group", [0, 32])
def test_loss_fn_value_and_grads_match_jax(group):
    """Remat on in both, the aux loss in the loss: the value and every
    gradient, ``layers.moe.*`` included, against jax.grad."""
    jcfg, tcfg = _configs(moe_group_size=group)
    params, port = _weights(jcfg, tcfg, seed=5)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(2, 33)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jnp.asarray(tokens), jcfg))(params)
    loss, grads = _port_loss_and_grads(port, tokens, tcfg)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    want = dict(_leaf_items(jax.tree.map(np.asarray, j_grads)))
    assert set(grads) == set(want)
    assert {"layers.moe.router", "layers.moe.w_gate", "layers.moe.w_up",
            "layers.moe.w_down"} <= set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


def test_aux_loss_is_summed_over_the_moe_layers():
    """hidden_states returns the MoE layers' aux (only layer 1 of 2 is
    sparse), as the JAX scan's carry does."""
    jcfg, tcfg = _configs(remat=False)
    params, port = _weights(jcfg, tcfg)
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    _, j_aux = jtfm.hidden_states(params, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        _, aux = ttfm.hidden_states(port, torch.from_numpy(tokens).long(),
                                    tcfg)
    assert aux.item() > 0
    np.testing.assert_allclose(aux.item(), float(j_aux), **LAYER_TOL)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_grouped_checkpoints_nest_inside_the_layer_remat(policy):
    """Each group's checkpoint inside the layer's (either remat policy)
    gives the gradients of the same model without any remat."""
    base = ttfm.ModelConfig.tiny_moe(moe_group_size=32, remat=False)
    cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
    _, port = _weights(jtfm.ModelConfig.tiny_moe(), base, seed=7)
    tokens = np.random.default_rng(7).integers(
        0, base.vocab_size, size=(2, 33)).astype(np.int32)
    l_ref, g_ref = _port_loss_and_grads(port, tokens, base)
    loss, grads = _port_loss_and_grads(port, tokens, cfg)
    np.testing.assert_allclose(loss, l_ref, rtol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("moe_every", [2, 1])
def test_train_steps_match_jax(moe_every):
    """3 build_train_step steps against the JAX step on a one-device
    mesh. moe_every 1 makes every layer sparse: the dense MLP weights go
    unused and take zero gradients in both (lax.cond's zeros)."""
    jcfg, tcfg = _configs(moe_every=moe_every, moe_group_size=32)
    mesh = build_mesh(MeshSpec(dp=1, pp=1, sp=1, tp=1))
    j_step, j_init = j_build_train_step(jcfg, mesh)
    j_params, j_state = j_init(jax.random.PRNGKey(0))
    step, _ = build_train_step(tcfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), tcfg,
                             device="cpu")
    opt_state = make_optimizer().init(params)
    tokens = np.random.default_rng(8).integers(
        0, tcfg.vocab_size, size=(2, 33)).astype(np.int32)
    for _ in range(3):
        j_params, j_state, j_m = j_step(j_params, j_state,
                                        jnp.asarray(tokens))
        params, opt_state, m = step(params, opt_state, tokens)
        np.testing.assert_allclose(m["loss"].item(), float(j_m["loss"]),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(j_m["grad_norm"]), rtol=STEP_RTOL)
    assert opt_state["count"] == 3
    assert len(opt_state["mu"]) == len(tree_leaves(params))


def test_params_from_jax_converts_moe():
    """The router stays float32; bfloat16 experts convert bit for bit."""
    jcfg = dataclasses.replace(jtfm.ModelConfig.tiny_moe(),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(ttfm.ModelConfig.tiny_moe(),
                               dtype=torch.bfloat16)
    params_np = jax.tree.map(np.asarray,
                             jtfm.init_params(jcfg, jax.random.PRNGKey(9)))
    moe = params_from_jax(params_np, tcfg, device="cpu")["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  params_np["layers"]["moe"]["router"])
    for name in ("w_gate", "w_up", "w_down"):
        assert moe[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            moe[name].view(torch.int16).numpy(),
            params_np["layers"]["moe"][name].view(np.int16))


def test_init_params_shapes_and_dtypes_follow_jax():
    jcfg, tcfg = _configs()
    got = dict(_leaf_items(ttfm.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu")))
    want = dict(_leaf_items(jax.eval_shape(
        lambda: jtfm.init_params(jcfg, jax.random.PRNGKey(0)))))
    assert set(got) == set(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == spec.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(spec.dtype), name


def test_moe_group_size_is_checked():
    with pytest.raises(ValueError, match="moe_group_size"):
        ttfm.ModelConfig.tiny_moe(moe_group_size=-1)


def test_chip_smoke_pins_the_plain_runs_routing():
    """chip_smoke.py compares a MoE model's kernel and plain-attention runs
    routed alike: a replayed run takes the recorded run's experts (here
    recorded with another router, so its own choices differ) and counts
    the routings it would have chosen otherwise."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = ttfm.ModelConfig.tiny_moe(moe_group_size=32)
    _, port = _weights(jtfm.ModelConfig.tiny_moe(), cfg, seed=10)
    other = {**port, "layers": {**port["layers"], "moe": {
        **port["layers"]["moe"],
        "router": port["layers"]["moe"]["router"].flip(-1)}}}
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, size=(2, 33))).long()
    topk = torch.topk
    pin = chip_smoke.PinnedRouting()
    with pin.record():
        ttfm.loss_fn(other, tokens, cfg)
    with pin.replay():
        pinned = ttfm.loss_fn(port, tokens, cfg)
    # 64 tokens through one MoE layer in two groups
    assert torch.topk is topk and pin.routings == 64
    assert 0 < pin.flips < pin.routings
    own = ttfm.loss_fn(port, tokens, cfg)
    assert not torch.equal(pinned, own)
    with pin.replay():  # the same record again: the same choices
        again = ttfm.loss_fn(port, tokens, cfg)
    assert torch.equal(again, pinned)

