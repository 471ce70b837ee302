"""The port's multichip dry run (``ray_tpu_torch.tools.multichip``)
against the JAX package's, on the CPU.

The port's side runs in four gloo ranks (``parallel.multihost.RankPool``);
the JAX side on the first four devices of the virtual 8-device CPU mesh
(tests/conftest.py), at the same mesh shape, with the same weights (the
JAX init's, converted through ``models/convert.py``) and the same
tokens, float32. Tolerances: each mesh step's loss and grad norm 1e-4
relative (tests/test_torch_training.py's, against the unsharded JAX
step); the entry forward's bf16 logits 2e-2 relative L2 (both sides
round every layer's bf16 matmuls, in other orders).
"""

import importlib

import jax
import numpy as np
import pytest

from ray_tpu.models import transformer as jtfm
from ray_tpu.models.training import build_pipeline_train_step as j_pipe
from ray_tpu.models.training import build_train_step as j_train
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as j_build_mesh
from ray_tpu_torch.parallel.multihost import RankPool
from ray_tpu_torch.tools import multichip

WORLD = 4
STEP_RTOL = 1e-4
ENTRY_REL_L2 = 2e-2


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD, backend="gloo", timeout_s=180,
                    env={"RAY_TPU_collective_op_timeout_s": "120"})
    pool.start()
    yield pool
    pool.close()


def test_dryrun_multichip_runs_every_step():
    """dryrun_multichip(4) on four gloo ranks of the CPU: the dp x sp x
    tp MoE step (sp2 x tp2: MeshSpec.auto(4, want_pp=False)), FSDP, the
    pp2 x tp2 pipeline and the train runtime driving step 1, each with a
    finite loss; the runtime's mesh step is step 1's, bit for bit."""
    rows = multichip.dryrun_multichip(WORLD, device="cpu", backend="gloo")
    assert [r["step"] for r in rows] == ["gspmd", "fsdp", "pipeline",
                                         "train"]
    assert [r["mesh"] for r in rows] == ["sp2 x tp2", "sp2 x tp2",
                                         "pp2 x tp2", "sp2 x tp2"]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert rows[3]["loss"] == rows[0]["loss"]
    for r in rows[:3]:
        assert r["backend"] == "gloo" and r["cards"] == [None] * WORLD


@pytest.mark.parametrize("name", ["gspmd", "fsdp", "pipeline"])
def test_dryrun_steps_match_jax(ranks, name):
    """Each mesh step of the plan against the JAX step at the same mesh
    shape, config, weights and tokens."""
    plan_step = next(p for p in multichip.dryrun_plan(WORLD)
                     if p["name"] == name)
    jcfg = jtfm.ModelConfig(**plan_step["model"],
                            dtype=jax.numpy.float32)
    mesh = j_build_mesh(JMeshSpec(**plan_step["axes"]))
    if plan_step["pipeline"]:
        step, init_fn = j_pipe(jcfg, mesh, num_microbatches=2)
    else:
        step, init_fn = j_train(jcfg, mesh, fsdp=plan_step["fsdp"],
                                sp_strategy="ring")
    params, opt_state = init_fn(jax.random.PRNGKey(plan_step["init_seed"]))
    params_np = jax.tree.map(np.asarray, params)
    tokens = multichip.step_tokens(plan_step).numpy()
    _, _, metrics = step(params, opt_state, tokens)
    want = (float(metrics["loss"]), float(metrics["grad_norm"]))
    for r in ranks.run(multichip.rank_step, plan_step, "cpu", params_np,
                       tokens):
        np.testing.assert_allclose((r["loss"], r["grad_norm"]), want,
                                   rtol=STEP_RTOL)
        assert r["staged_bytes"] == 0  # CPU tensors: nothing staged


def test_entry_matches_jax_entry():
    """entry(device="cpu") is the JAX entry()'s forward: its config, and
    on the JAX entry's weights (converted) and tokens the same logits."""
    import torch

    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.transformer import ModelConfig

    j_fn, (j_params, j_tokens) = importlib.import_module(
        "__graft_entry__").entry()
    want = np.asarray(j_fn(j_params, j_tokens), np.float32)
    fwd, (params, tokens) = multichip.entry(device="cpu")
    assert tokens.shape == j_tokens.shape and not tokens.any()
    assert params["embed"].dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in params["layers"].items()} == \
        {k: tuple(v.shape) for k, v in j_params["layers"].items()}
    cfg = ModelConfig(vocab_size=2048, hidden=256, layers=4, heads=8,
                      kv_heads=4, intermediate=704, max_seq=512,
                      dtype=torch.bfloat16, remat=False)
    got = fwd(params_from_jax(jax.tree.map(np.asarray, j_params), cfg,
                              device="cpu"), tokens).float().numpy()
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < ENTRY_REL_L2, rel


def test_nccl_pool_with_too_few_cards_raises_before_it_spawns():
    """NCCL with one card a rank needs as many visible cards as ranks:
    here none are visible, and the pool raises naming both counts with
    no rank started."""
    pool = RankPool(WORLD, backend="nccl", cuda_device="per_rank")
    with pytest.raises(RuntimeError, match=r"4 ranks need 4 visible CUDA "
                                           r"cards, 0 visible"):
        pool.start()
    assert pool._procs == [] and pool._dir is None
