"""Ulysses sequence parallelism, the dp x sp train step and the
multi-host mesh helpers of the port against the JAX package's, on the
CPU.

The port's side runs in four gloo ranks (``parallel.multihost.RankPool``,
started once for the module); the JAX side on the virtual 8-device CPU
mesh (tests/conftest.py), its first four devices, with the same
numpy-seeded float32 inputs and weights. Tolerances: Ulysses output and
gradients 1e-5 absolute (float32 attention on both sides, blockwise in
the port and the JAX package's flash attention, apart by summation
order); the train step's loss and grad norm 1e-4 relative per step (the
tolerance of tests/test_torch_training.py against the unsharded JAX
step; each step's update feeds the next) and its updated parameters
3e-5 absolute after two steps: an AdamW step moves a weight by about
lr = 3e-4 in a direction m / sqrt(v) that, for a gradient near the
summation-order noise, differs between the two by a few percent; a
tenth of a step still shows any weight moved the wrong way. Ring
against Ulysses in the port 1e-5 relative on the loss
(tests/test_ulysses.py allows 1e-3).
"""

import dataclasses
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from ray_tpu.models import transformer as jtfm
from ray_tpu.models.training import build_train_step as j_build_train_step
from ray_tpu.ops.attention import flash_attention as j_flash
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as j_build_mesh
from ray_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from ray_tpu_torch.parallel.multihost import RankPool

cloudpickle.register_pickle_by_value(sys.modules[__name__])

WORLD = 4
ATTN_TOL = dict(atol=1e-5, rtol=0)
STEP_RTOL = 1e-4
PARAM_TOL = dict(atol=3e-5, rtol=0)
TRAIN_STEPS = 2


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD, backend="gloo", timeout_s=180,
                    env={"RAY_TPU_collective_op_timeout_s": "120"})
    pool.start()
    yield pool
    pool.close()


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _cfgs():
    """tests/test_ulysses.py's model; the port's with remat, so the
    sequence-parallel collectives also run in the recompute."""
    jcfg = jtfm.ModelConfig(vocab_size=128, hidden=64, layers=2, heads=8,
                            kv_heads=8, intermediate=128, max_seq=64,
                            dtype=jnp.float32, remat=False)
    from ray_tpu_torch.models.transformer import ModelConfig

    import torch

    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ModelConfig)
              if hasattr(jcfg, f.name)}
    fields.update(dtype=torch.float32, remat=True)
    return jcfg, ModelConfig(**fields)


# -- rank-side scenarios -----------------------------------------------------


def _rank():
    import torch.distributed as dist

    return dist.get_rank()


def rank_ulysses(q, k, v, causal):
    import torch

    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, shard_map
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    r = _rank()
    local = [torch.from_numpy(np.split(a, WORLD, 1)[r]).requires_grad_()
             for a in (q, k, v)]
    with shard_map(build_mesh(MeshSpec(sp=WORLD), device_type="cpu")):
        out = ulysses_attention(*local, "sp", causal=causal)
        grads = torch.autograd.grad((out ** 2).sum(), local)
    return out.detach().numpy(), [g.numpy() for g in grads]


def rank_ulysses_indivisible():
    import torch

    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, shard_map
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    q = torch.zeros(1, 8, 3, 8)  # 3 heads over 4 ranks
    with shard_map(build_mesh(MeshSpec(sp=WORLD), device_type="cpu")):
        try:
            ulysses_attention(q, q, q, "sp")
        except ValueError as exc:
            return str(exc)
    return None


def rank_train(params_np, tokens, sp_strategy, steps):
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.training import (
        build_train_step,
        make_optimizer,
        tree_leaves,
    )
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    _, cfg = _cfgs()
    mesh = build_mesh(MeshSpec(dp=2, sp=2), device_type="cpu")
    opt = make_optimizer()
    step, _ = build_train_step(cfg, mesh=mesh, sp_strategy=sp_strategy,
                               optimizer=opt)
    params = params_from_jax(params_np, cfg, device="cpu")
    opt_state = opt.init(params)
    metrics = []
    for _ in range(steps):
        params, opt_state, m = step(params, opt_state, tokens)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return metrics, [p.detach().numpy() for p in tree_leaves(params)]


def rank_unported_meshes():
    """What the port's mesh steps still refuse, each with its message (or
    None where nothing raised): tp not dividing heads, and MoE on the
    pipeline (the JAX package refuses both)."""
    from ray_tpu_torch.models.training import (
        build_forward,
        build_pipeline_train_step,
    )
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    _, cfg = _cfgs()
    moe = dataclasses.replace(cfg, num_experts=4)
    tp4 = build_mesh(MeshSpec(tp=4), device_type="cpu")
    pp = build_mesh(MeshSpec(pp=2, tp=2), device_type="cpu")

    messages = []
    for call, kind in (
            (lambda: build_forward(dataclasses.replace(cfg, heads=2,
                                                       kv_heads=2),
                                   mesh=tp4), ValueError),
            (lambda: build_pipeline_train_step(moe, pp), ValueError)):
        try:
            call()
            messages.append(None)
        except kind as exc:
            messages.append(str(exc))
    return messages


def rank_multihost():
    import torch

    from ray_tpu_torch.collective.api import ici
    from ray_tpu_torch.parallel.mesh import shard_map
    from ray_tpu_torch.parallel.multihost import (
        multihost_mesh,
        process_count,
        process_index,
        sync_global_devices,
    )

    mesh = multihost_mesh({"dp": 2, "tp": 2}, device_type="cpu")
    # dp spans the "hosts" (slowest in rank order), tp varies fastest
    default = mesh.mesh.tolist()
    across = multihost_mesh({"dp": 2, "tp": 2}, dcn_axes=["tp"],
                            device_type="cpu").mesh.tolist()
    try:
        multihost_mesh({"dp": 3, "tp": 5}, device_type="cpu")
        mismatch = None
    except ValueError as exc:
        mismatch = str(exc)
    with shard_map(mesh):
        total = ici.allreduce(torch.ones(2, 4), ("dp", "tp")).sum().item()
    sync_global_devices("test")
    return {"names": mesh.mesh_dim_names, "default": default,
            "across": across, "mismatch": mismatch, "total": total,
            "count": process_count(), "index": process_index()}


# -- the tests ---------------------------------------------------------------


def _j_ulysses(q, k, v, causal):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    return jax.shard_map(
        lambda a, b, c: j_ulysses(a, b, c, "sp", causal=causal),
        mesh=mesh, in_specs=(P(None, "sp", None, None),) * 3,
        out_specs=P(None, "sp", None, None))(q, k, v)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_and_full_attention(ranks, causal):
    q, k, v = _qkv(0, 2, 64, 4, 16)
    results = ranks.run(rank_ulysses, q, k, v, causal)
    got = np.concatenate([o for o, _ in results], axis=1)
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(_j_ulysses, static_argnums=3)(
            q, k, v, causal)), **ATTN_TOL)
    np.testing.assert_allclose(
        got, np.asarray(j_flash(q, k, v, causal=causal)), **ATTN_TOL)
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(_j_ulysses(*a, causal) ** 2),
        argnums=(0, 1, 2)))(q, k, v)
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(
            np.concatenate([g[i] for _, g in results], axis=1),
            np.asarray(want[i]), **ATTN_TOL, err_msg=f"d{name}")


def test_ulysses_rejects_indivisible_heads(ranks):
    for message in ranks.run(rank_ulysses_indivisible):
        assert message is not None and "divisible" in message


@pytest.fixture(scope="module")
def jax_train():
    """The JAX dp2 x sp2 step's weights, tokens and metrics per
    strategy (tests/test_ulysses.py's model and tokens)."""
    jcfg, _ = _cfgs()
    mesh = j_build_mesh(JMeshSpec(dp=2, sp=2))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 33),
                                         0, 128))
    out = {}
    for strategy in ("ulysses", "ring"):
        step, init_fn = j_build_train_step(jcfg, mesh, sp_strategy=strategy)
        params, opt_state = init_fn(jax.random.PRNGKey(0))
        params_np = jax.tree.map(np.asarray, params)
        metrics = []
        for _ in range(TRAIN_STEPS):
            params, opt_state, m = step(params, opt_state, tokens)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[strategy] = (params_np, metrics,
                         [np.asarray(p) for p in jax.tree.leaves(params)])
    return tokens, out


@pytest.mark.parametrize("strategy", ["ulysses", "ring"])
def test_train_step_dp2_sp2_matches_jax(ranks, jax_train, strategy):
    tokens, runs = jax_train
    params_np, want_metrics, want_params = runs[strategy]
    results = ranks.run(rank_train, params_np, tokens, strategy,
                        TRAIN_STEPS)
    for metrics, params in results:  # every rank: the same global step
        np.testing.assert_allclose(np.array(metrics),
                                   np.array(want_metrics), rtol=STEP_RTOL)
        for got, want in zip(params, want_params):
            np.testing.assert_allclose(got, want, **PARAM_TOL)


def test_ring_and_ulysses_train_alike(ranks, jax_train):
    tokens, runs = jax_train
    params_np = runs["ring"][0]
    ring = ranks.run(rank_train, params_np, tokens, "ring", 1)[0][0]
    ulysses = ranks.run(rank_train, params_np, tokens, "ulysses", 1)[0][0]
    np.testing.assert_allclose(ring, ulysses, rtol=1e-5)


def test_unported_shardings_raise(ranks):
    """tp, FSDP and MoE on dp x tp run since the tensor-parallel port
    (tests/test_torch_tensor_parallel.py), MoE with sp > 1 and groups
    across ranks since tests/test_torch_moe_mesh.py; these still raise,
    as they do in the JAX package."""
    for heads, pipe_moe in ranks.run(rank_unported_meshes):
        assert heads is not None and "does not divide heads" in heads
        assert pipe_moe is not None and "pipeline" in pipe_moe


def test_multihost_mesh_and_barrier(ranks):
    for rank, facts in enumerate(ranks.run(rank_multihost)):
        assert facts["names"] == ("dp", "tp")
        assert facts["default"] == [[0, 1], [2, 3]]
        assert facts["across"] == [[0, 2], [1, 3]]
        assert facts["mismatch"] is not None and "need" in \
            facts["mismatch"]
        assert facts["total"] == 32.0  # 4 ranks x 8 ones
        assert (facts["count"], facts["index"]) == (WORLD, rank)
