"""MoE on the port's mesh train step where a rank's tokens are not whole
groups of the global routing order: sequence parallelism (sp > 1, ring
and Ulysses) and groups that span dp and sp ranks, against the JAX
package's GSPMD step on the same mesh, on the CPU.

The harness is tests/test_torch_tensor_parallel.py's: four gloo ranks
(``parallel.multihost.RankPool``, started once for this module), the JAX
side on the first four devices of the virtual 8-device CPU mesh, the JAX
init's weights converted, numpy-seeded tokens, float32. Tolerances as
there: 3 steps' loss and grad norm 1e-4 relative, the first step's
gradients 1e-4 absolute against ``jax.grad`` of the unsharded loss (the
rank's shard of it), each rank's parameter shards exactly the JAX
mesh's. The loss includes the MoE aux loss.
"""

import sys

import cloudpickle
import jax.numpy as jnp
import pytest

import test_torch_tensor_parallel as tpt
from ray_tpu.models import transformer as jtfm
from ray_tpu_torch.parallel.multihost import RankPool

cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(tpt)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(tpt.WORLD, backend="gloo", timeout_s=180,
                    env={"RAY_TPU_collective_op_timeout_s": "120"})
    pool.start()
    yield pool
    pool.close()


def _dryrun_moe(**kw):
    """The JAX multichip dry run's MoE config (__graft_entry__.py's
    step 1) at 2 experts, as at dp 1."""
    return jtfm.ModelConfig(
        vocab_size=128, hidden=64, layers=2, heads=4, kv_heads=4,
        intermediate=128, max_seq=64, dtype=jnp.float32, num_experts=2,
        remat=False, **kw)


def _tiny_moe(**kw):
    return jtfm.ModelConfig.tiny_moe(**kw)


CASES = {
    # R1: MoE with sp > 1. The dry run's first step (MeshSpec.auto(4,
    # want_pp=False) is dp1 x sp2 x tp2) ...
    "dryrun_sp2_tp2_ring": (_dryrun_moe, dict(sp=2, tp=2), "ring",
                            (2, 33)),
    # ... and dp2 x sp2, each sp strategy, on both configs
    "dryrun_dp2_sp2_ring": (_dryrun_moe, dict(dp=2, sp=2), "ring", (4, 33)),
    "dryrun_dp2_sp2_ulysses": (_dryrun_moe, dict(dp=2, sp=2), "ulysses",
                               (4, 33)),
    "tiny_sp2_tp2_ring": (_tiny_moe, dict(sp=2, tp=2), "ring", (4, 33)),
    "tiny_dp2_sp2_ring": (_tiny_moe, dict(dp=2, sp=2), "ring", (4, 33)),
    "tiny_dp2_sp2_ulysses": (_tiny_moe, dict(dp=2, sp=2), "ulysses",
                             (4, 33)),
    # R2: 64-token groups over dp ranks of 32 tokens (each group spans
    # two dp ranks) ...
    "tiny_g64_dp4": (lambda: _tiny_moe(moe_group_size=64), dict(dp=4),
                     "ring", (4, 33)),
    # ... and over sp ranks: a group is two 32-token rows, each row cut
    # over the two sp ranks of its dp rank
    "tiny_g64_dp2_sp2": (lambda: _tiny_moe(moe_group_size=64),
                         dict(dp=2, sp=2), "ring", (4, 33)),
    # a group of 48 tokens starts and ends inside other ranks' segments
    "tiny_g48_dp2_sp2": (lambda: _tiny_moe(moe_group_size=48),
                         dict(dp=2, sp=2), "ulysses", (6, 33)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mesh_train_step_matches_jax(ranks, case):
    """Each rank's shards are the JAX mesh's, its first gradients the
    shard of jax.grad's, and 3 steps' loss and grad norm the JAX mesh
    step's."""
    make_cfg, spec, strategy, shape = CASES[case]
    jcfg = make_cfg()
    tokens = tpt._tokens(11, shape, vocab=jcfg.vocab_size)
    # the AdamW moments' shards are not compared: GSPMD may lay the JAX
    # moments out otherwise than their parameters (at dp2 x sp2 it cuts
    # the dense w_gate's moments over sp), the port keeps them as its
    # parameter shards
    params_np, held, _, metrics = tpt._jax_run(
        jcfg, spec, tokens, 3, sp_strategy=strategy)
    want_grads = tpt._want_grads(jcfg, params_np, tokens)
    results = ranks.run(tpt.rank_train, jcfg, params_np, tokens, spec, 3,
                        sp_strategy=strategy, with_grads=True)
    for rank, result in enumerate(results):
        tpt._check_rank(rank, result, held, None, metrics, want_grads,
                        spec, jcfg=jcfg)
