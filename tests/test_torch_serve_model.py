"""The slice as a whole on the CPU: the debug transformer served through
both packages' ``serve``.

``ModelConfig.debug()`` (fp32, head_dim 16) is deployed by
``ray_tpu.serve`` with the JAX package's ``build_forward`` and by
``ray_tpu_torch.serve`` with the port's, on the same JAX weights
(``params_from_jax`` for the port). Both deployments batch with
``@serve.batch(max_batch_size=4)`` and a wait far longer than the test,
so a batch closes only when four requests are queued: two groups of four
requests sent together form the same two batches on both sides. Each
answer, the request's last-position logits, agrees within ``MODEL_TOL``
(atol = rtol = 1e-4, tests/test_torch_model.py): fp32 rounding
differences of the two matmul libraries through the stack. On the CPU
the port's attention is the plain version.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jax_serve
from ray_tpu.models import transformer as jtfm
from ray_tpu.models.training import build_forward as j_build_forward
from ray_tpu_torch import serve
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.training import build_forward

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
BATCH = 4
GROUPS = 2
SEQ = 32


@pytest.fixture
def no_jax_runtime():
    """No JAX runtime when the test starts its own. A JAX serve
    controller that a test killed keeps its loops running, and once its
    runtime is down they start a new one every few ticks (ROADMAP Queue
    C); under --dist loadfile this file may share a process with those
    tests, so end such loops and any runtime they started first."""
    from ray_tpu.serve.controller import ServeController

    for obj in gc.get_objects():
        if isinstance(obj, ServeController):
            obj._stopped = True
            obj._health_thread.join(timeout=10)
            obj._autoscale_thread.join(timeout=10)
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _deployment(serve_mod, forward_last):
    """A deployment whose batched ``__call__`` stacks token rows into one
    [n, SEQ] batch and answers each with its last-position logits."""

    class DebugLM:
        def __init__(self, params):
            self.params = params
            self.batch_sizes = []

        @serve_mod.batch(max_batch_size=BATCH, batch_wait_timeout_s=60.0)
        def __call__(self, rows):
            self.batch_sizes.append(len(rows))
            return list(forward_last(self.params, np.stack(rows)))

        def sizes(self):
            return self.batch_sizes

    return serve_mod.deployment(name="debug_lm")(DebugLM)


def _serve(rt_mod, serve_mod, deployment, params, rows):
    """Deploy, send the rows in groups of BATCH, return the answers and
    the batch sizes the replica saw."""
    try:
        serve_mod.start()
        deployment.deploy(params)
        handle = deployment.get_handle()
        answers = []
        for g in range(GROUPS):
            group = rows[g * BATCH:(g + 1) * BATCH]
            answers += rt_mod.get([handle.remote(r) for r in group],
                                  timeout=120)
        sizes = rt_mod.get(handle.sizes.remote())
    finally:
        serve_mod.shutdown()
        rt_mod.shutdown()
    return np.stack(answers), sizes


def test_debug_model_served_alike_by_both_serves(no_jax_runtime):
    jcfg = jtfm.ModelConfig.debug(remat=False)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(8))
    params_np = jax.tree.map(np.asarray, jparams)
    rows = list(np.random.default_rng(8).integers(
        0, jcfg.vocab_size, size=(GROUPS * BATCH, SEQ)).astype(np.int32))
    j_fwd = j_build_forward(jcfg)

    def jax_last(params, tokens):
        return np.asarray(j_fwd(params, jnp.asarray(tokens))[:, -1])

    ray_tpu.init(num_cpus=8)
    ref, ref_sizes = _serve(ray_tpu, jax_serve,
                            _deployment(jax_serve, jax_last), jparams, rows)

    tcfg = ttfm.ModelConfig.debug()
    t_fwd = build_forward(tcfg, device="cpu")

    def port_last(params, tokens):
        return t_fwd(params, torch.from_numpy(tokens))[:, -1].numpy()

    ray_tpu_torch.init(num_cpus=8, device="cpu")
    ours, sizes = _serve(ray_tpu_torch, serve,
                         _deployment(serve, port_last),
                         params_from_jax(params_np, tcfg, "cpu"), rows)

    assert ref_sizes == sizes == [BATCH] * GROUPS
    assert ours.shape == ref.shape == (GROUPS * BATCH, jcfg.vocab_size)
    np.testing.assert_allclose(ours, ref, **MODEL_TOL)
