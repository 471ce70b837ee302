"""Tensor, fully-sharded and expert parallelism in the port's mesh train
steps, and the checkpoint restore across mesh layouts, against the JAX
package's GSPMD steps, on the CPU.

The port's side runs in four gloo ranks (``parallel.multihost.RankPool``,
started once for the module); the JAX side on the virtual 8-device CPU
mesh (tests/conftest.py), its first four devices, at the same layout,
with the same weights (the JAX init's, converted) and numpy-seeded
tokens, all float32. Tolerances: loss and grad norm per step 1e-4
relative (tests/test_torch_training.py's, against the unsharded JAX
step; each step's update feeds the next); one step's gradients 1e-4
absolute against ``jax.grad`` of the unsharded loss, the rank's shard of
it; forward logits 1e-5 absolute; a restored state's next step within
1e-4 relative of the step the saved layout took next (the JAX test asks
only for < 0.5 absolute). Each rank's parameter and AdamW-moment shards
are compared with the JAX arrays' ``addressable_shards`` exactly.
"""

import dataclasses
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import transformer as jtfm
from ray_tpu.models.training import build_forward as j_build_forward
from ray_tpu.models.training import (
    build_pipeline_train_step as j_build_pipeline_train_step,
)
from ray_tpu.models.training import build_train_step as j_build_train_step
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as j_build_mesh
from ray_tpu_torch.parallel.multihost import RankPool

cloudpickle.register_pickle_by_value(sys.modules[__name__])

WORLD = 4
STEP_RTOL = 1e-4
GRAD_TOL = dict(atol=1e-4, rtol=0)
LOGIT_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD, backend="gloo", timeout_s=180,
                    env={"RAY_TPU_collective_op_timeout_s": "120"})
    pool.start()
    yield pool
    pool.close()


def _port_cfg(jcfg):
    """The port's ModelConfig with ``jcfg``'s fields, float32."""
    import torch

    from ray_tpu_torch.models.transformer import ModelConfig

    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ModelConfig)
              if hasattr(jcfg, f.name)}
    fields["dtype"] = torch.float32
    return ModelConfig(**fields)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in tree
                for n, v in _named(tree[k], f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def _held(tree):
    """{leaf name: {device id: the shard it holds}} of a sharded JAX
    tree."""
    return {name: {sh.device.id: np.asarray(sh.data)
                   for sh in leaf.addressable_shards}
            for name, leaf in _named(tree).items()}


def _adam_moments(opt_state):
    """The ``mu`` and ``nu`` trees of an optax adamw state."""
    adam = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return adam[0].mu, adam[0].nu


def _jax_run(jcfg, spec, tokens, steps, *, fsdp=False, sp_strategy="ring",
             pipeline=False):
    """The JAX mesh step from PRNGKey(0): (numpy weights, what each
    device holds of them, what each holds of the first step's adam
    moments, [(loss, grad norm)] per step)."""
    mesh = j_build_mesh(JMeshSpec(**spec))
    if pipeline:
        step, init_fn = j_build_pipeline_train_step(jcfg, mesh,
                                                    num_microbatches=2)
    else:
        step, init_fn = j_build_train_step(jcfg, mesh, fsdp=fsdp,
                                           sp_strategy=sp_strategy)
    params, opt_state = init_fn(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    held = _held(params)
    metrics, moments = [], None
    for _ in range(steps):
        params, opt_state, m = step(params, opt_state, tokens)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if moments is None:
            moments = [_held(t) for t in _adam_moments(opt_state)]
    return params_np, held, moments, metrics


def _want_grads(jcfg, params_np, tokens):
    return {k: np.asarray(v) for k, v in _named(jax.jit(
        jax.grad(jtfm.loss_fn), static_argnums=2)(
            params_np, tokens, jcfg)).items()}


def _check_rank(rank, result, held, moments, metrics, want_grads=None,
                spec=None, fsdp=False, jcfg=None):
    """One rank's shards, first-step gradients and metrics against the
    JAX run's."""
    for name, value in result["params"].items():
        np.testing.assert_array_equal(value, held[name][rank],
                                      err_msg=name)
    if moments is not None:
        for got, want in zip(result["moments"], moments):
            assert {k: v.shape for k, v in got.items()} == \
                {k: w[rank].shape for k, w in want.items()}
    if want_grads is not None:
        for name, g in result["grads"].items():
            want = _cut(want_grads[name], name, rank, spec, fsdp, jcfg)
            np.testing.assert_allclose(g, want, **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(np.array(result["metrics"]),
                               np.array(metrics), rtol=STEP_RTOL)


def _cut(array, name, rank, spec, fsdp, jcfg):
    """This rank's shard of the full ``array`` of leaf ``name`` under the
    port's rule table (its mesh coordinates in AXIS_ORDER)."""
    from ray_tpu_torch.models.transformer import logical_axes
    from ray_tpu_torch.parallel.mesh import (
        AXIS_ORDER,
        DEFAULT_RULES,
        fsdp_rules,
        spec_for,
    )

    sizes = dict(zip(AXIS_ORDER, JMeshSpec(**spec).axis_sizes()))
    coords = dict(zip(AXIS_ORDER, np.unravel_index(rank, tuple(
        sizes.values()))))
    axes = logical_axes(_port_cfg(jcfg))
    for part in name.split("."):
        axes = axes[part]
    for dim, axis in enumerate(spec_for(
            axes, fsdp_rules() if fsdp else DEFAULT_RULES)):
        if axis is not None and sizes[axis] > 1:
            array = np.split(array, sizes[axis], axis=dim)[coords[axis]]
    return array


# -- rank-side scenarios -----------------------------------------------------


def _mesh(spec):
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec(**spec), device_type="cpu")


def rank_train(jcfg, params_np, tokens, spec, steps, fsdp=False,
               sp_strategy="ring", pipeline=False, with_grads=False):
    """The port's mesh step on this rank: its parameter shards, its
    first step's moment shapes, (with_grads) its gradients before any
    update, and the metrics of ``steps`` steps."""
    from ray_tpu_torch.models.convert import local_params, params_from_jax
    from ray_tpu_torch.models.training import (
        build_pipeline_train_step,
        build_train_step,
        make_optimizer,
        param_shardings,
    )

    cfg = _port_cfg(jcfg)
    mesh = _mesh(spec)
    opt = make_optimizer()
    if pipeline:
        step, _ = build_pipeline_train_step(cfg, mesh, num_microbatches=2,
                                            optimizer=opt)
    else:
        step, _ = build_train_step(cfg, mesh=mesh, fsdp=fsdp, optimizer=opt,
                                   sp_strategy=sp_strategy)
    params = local_params(params_from_jax(params_np, cfg, device="cpu"),
                          param_shardings(cfg, mesh, fsdp), mesh)
    out = {"params": {k: v.detach().numpy().copy()
                      for k, v in _named(params).items()}}
    names = list(out["params"])
    if with_grads:
        _, grads, _ = step.loss_and_grads(params, tokens)
        out["grads"] = dict(zip(names, (g.numpy() for g in grads)))
    opt_state = opt.init(params)
    metrics = []
    for i in range(steps):
        params, opt_state, m = step(params, opt_state, tokens)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        if i == 0:
            out["moments"] = [dict(zip(names, (t.numpy() for t in
                                                opt_state[key])))
                              for key in ("mu", "nu")]
    out["metrics"] = metrics
    return out


def rank_forward(jcfg, params_np, tokens, spec):
    from ray_tpu_torch.models.convert import local_params, params_from_jax
    from ray_tpu_torch.models.training import build_forward, param_shardings

    cfg = _port_cfg(jcfg)
    mesh = _mesh(spec)
    params = local_params(params_from_jax(params_np, cfg, device="cpu"),
                          param_shardings(cfg, mesh), mesh)
    return build_forward(cfg, mesh=mesh)(params, tokens).numpy()


def rank_restore(jcfg, params_np, tokens, directory):
    """3 steps at dp2 x tp2, saved with DCP; that state restored onto
    tp4, onto one device (no ``like``: full CPU tensors) and, saved from
    there as a one-card checkpoint, back onto dp2 x tp2; each restored
    state takes the 4th step. -> what each saw."""
    import os

    import torch.distributed as dist

    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.convert import (
        checkpoint_state,
        local_params,
        params_from_jax,
        train_state,
    )
    from ray_tpu_torch.models.training import (
        build_train_step,
        make_optimizer,
        param_shardings,
    )

    cfg = _port_cfg(jcfg)

    def at(spec):
        mesh = _mesh(spec)
        step, init_fn = build_train_step(cfg, mesh=mesh)
        return mesh, param_shardings(cfg, mesh), step, init_fn

    def onto(ckpt, spec):
        mesh, shardings, step, init_fn = at(spec)
        fresh_p, fresh_o = init_fn()
        like = checkpoint_state({"params": fresh_p, "opt_state": fresh_o},
                                shardings, mesh)
        state = train_state(ckpt.restore(3, like))
        _, _, m = step(state["params"], state["opt_state"], tokens)
        return m["loss"].item(), m["grad_norm"].item()

    mesh, shardings, step, _ = at(DP_TP)
    params = local_params(params_from_jax(params_np, cfg, device="cpu"),
                          shardings, mesh)
    opt_state = make_optimizer().init(params)
    for _ in range(3):
        params, opt_state, _ = step(params, opt_state, tokens)
    ckpt = CheckpointManager(os.path.join(directory, "mesh"))
    state = checkpoint_state({"params": params, "opt_state": opt_state},
                             shardings, mesh)
    try:
        ckpt.save(3, state, wait=False)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    ckpt.save(3, state)
    out = {"steps": ckpt.all_steps(), "tp4": onto(ckpt, dict(tp=4)),
           "async_refused": refused}
    full = train_state(ckpt.restore(3))
    out["full_shapes"] = {k: tuple(v.shape)
                          for k, v in _named(full["params"]).items()}
    out["count"] = full["opt_state"]["count"]
    one_card = CheckpointManager(os.path.join(directory, "one"))
    if dist.get_rank() == 0:
        one_card.save(3, checkpoint_state(full))
    dist.barrier()
    step_1, _ = build_train_step(cfg, device="cpu")
    _, _, m = step_1(full["params"], full["opt_state"], tokens)
    out["one_device"] = (m["loss"].item(), m["grad_norm"].item())
    out["dp2_tp2_from_one_card"] = onto(one_card, DP_TP)
    return out


# -- the tests ---------------------------------------------------------------

DP_TP = dict(dp=2, tp=2)


@pytest.fixture(scope="module")
def tp_run():
    """The JAX dp2 x tp2 step of ModelConfig.debug, 4 steps (the 4th is
    the restore scenario's next step)."""
    jcfg = jtfm.ModelConfig.debug()
    tokens = _tokens(1, (4, 33))
    params_np, held, moments, metrics = _jax_run(jcfg, DP_TP, tokens, 4)
    return jcfg, tokens, params_np, held, moments, metrics


def test_tp_train_step_matches_jax(ranks, tp_run):
    """dp2 x tp2: each rank's shards are the JAX mesh's, its first
    gradients the shard of jax.grad's, and 3 steps' metrics the JAX
    step's."""
    jcfg, tokens, params_np, held, moments, metrics = tp_run
    want_grads = _want_grads(jcfg, params_np, tokens)
    results = ranks.run(rank_train, jcfg, params_np, tokens, DP_TP, 3,
                        with_grads=True)
    for rank, result in enumerate(results):
        _check_rank(rank, result, held, moments, metrics[:3], want_grads,
                    DP_TP, jcfg=jcfg)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_tp_train_step_matches_jax(ranks, strategy):
    jcfg = jtfm.ModelConfig.debug()
    spec = dict(sp=2, tp=2)
    tokens = _tokens(2, (4, 33))
    params_np, held, _, metrics = _jax_run(jcfg, spec, tokens, 2,
                                           sp_strategy=strategy)
    results = ranks.run(rank_train, jcfg, params_np, tokens, spec, 2,
                        sp_strategy=strategy)
    for rank, result in enumerate(results):
        _check_rank(rank, result, held, None, metrics)


@pytest.mark.parametrize("spec", [dict(tp=4), dict(sp=2, tp=2),
                                  dict(dp=2, tp=2)])
def test_tp_forward_matches_jax(ranks, spec):
    """The logits of each rank's [B/dp, S/sp] window, gathered over tp,
    against the JAX forward's; at tp 4 the debug model's 2 kv heads
    span two ranks each."""
    jcfg = jtfm.ModelConfig.debug()
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(3))
    params_np = jax.tree.map(np.asarray, params)
    tokens = _tokens(4, (2, 32))
    want = np.asarray(j_build_forward(jcfg)(params, tokens))
    sizes = JMeshSpec(**spec)
    for rank, got in enumerate(ranks.run(rank_forward, jcfg, params_np,
                                         tokens, spec)):
        d, _, r, _ = np.unravel_index(rank, sizes.axis_sizes())
        b, s = 2 // sizes.dp, 32 // sizes.sp
        np.testing.assert_allclose(
            got, want[d * b:(d + 1) * b, r * s:(r + 1) * s], **LOGIT_TOL)


def test_fsdp_train_step_matches_jax(ranks):
    """dp4 with fsdp=True: the parameters and the AdamW moments are each
    rank's 1/dp shard, as the JAX opt_state's shards are (ZeRO), and 2
    steps equal the JAX step's."""
    jcfg = jtfm.ModelConfig.debug()
    spec = dict(dp=4)
    tokens = _tokens(5, (8, 17))
    params_np, held, moments, metrics = _jax_run(jcfg, spec, tokens, 2,
                                                 fsdp=True)
    want_grads = _want_grads(jcfg, params_np, tokens)
    results = ranks.run(rank_train, jcfg, params_np, tokens, spec, 2,
                        fsdp=True, with_grads=True)
    for rank, result in enumerate(results):
        _check_rank(rank, result, held, moments, metrics, want_grads, spec,
                    fsdp=True, jcfg=jcfg)
        sizes = [v.size for v in result["moments"][0].values()]
        full = [v.size for v in _named(params_np).values()]
        assert sum(sizes) * 4 == sum(full)  # every leaf split four ways


@pytest.mark.parametrize("group_size", [0, 32])
def test_moe_ep_train_step_matches_jax(ranks, group_size):
    """tiny_moe at dp2 x tp2: experts over dp (ep), their mlp columns
    over tp; ungrouped routing spans the ranks (global capacity, slot
    positions and aux means), 32-token groups lie within a rank. The
    loss includes the aux loss."""
    jcfg = jtfm.ModelConfig.tiny_moe(moe_group_size=group_size)
    tokens = _tokens(6, (8, 17))
    params_np, held, moments, metrics = _jax_run(jcfg, DP_TP, tokens, 3)
    results = ranks.run(rank_train, jcfg, params_np, tokens, DP_TP, 3)
    for rank, result in enumerate(results):
        _check_rank(rank, result, held, moments, metrics)


def test_pipeline_tp_train_step_matches_jax(ranks):
    """pp2 x tp2 through build_pipeline_train_step, the port's loss in
    16-token vocab-parallel chunks (the JAX pipeline's loss is
    unchunked: the same function)."""
    jcfg = jtfm.ModelConfig.debug(logits_chunk=16)
    spec = dict(pp=2, tp=2)
    tokens = _tokens(7, (4, 33))
    params_np, held, moments, metrics = _jax_run(jcfg, spec, tokens, 3,
                                                 pipeline=True)
    results = ranks.run(rank_train, jcfg, params_np, tokens, spec, 3,
                        pipeline=True)
    for rank, result in enumerate(results):
        _check_rank(rank, result, held, moments, metrics)


def test_restore_across_mesh_layouts(ranks, tp_run, tmp_path):
    """A state saved at dp2 x tp2 after 3 steps restores onto tp4, onto
    one device and, as a one-card save, back onto dp2 x tp2; each takes
    the 4th step of the dp2 x tp2 run (tests/test_model.py's
    test_orbax_restore_across_mesh_layouts asks for < 0.5)."""
    jcfg, tokens, params_np, _, _, metrics = tp_run
    results = ranks.run(rank_restore, jcfg, params_np, tokens,
                        str(tmp_path))
    full = {k: v.shape for k, v in _named(params_np).items()}
    for result in results:
        assert result["steps"] == [3] and result["count"] == 3
        assert "synchronous" in result["async_refused"]
        assert result["full_shapes"] == full
        for where in ("tp4", "one_device", "dp2_tp2_from_one_card"):
            np.testing.assert_allclose(result[where], metrics[3],
                                       rtol=STEP_RTOL, err_msg=where)
