"""The float32 references against the port's CPU path at tiny sizes, and
the yardstick's imports: no part of the program, no JAX."""

import ast
import functools

import pytest
import torch

from bench_port import inputs, reference
from bench_port.inputs import flatten
from bench_port.tests import tiny
from bench_port.tests.conftest import ROOT

YARDSTICK = ["reference", "inputs", "check.py", "work.py", "weights.py",
             "metrics"]
FORBIDDEN = {"jax", "jaxlib", "flax", "ray_tpu", "ray_tpu_torch"}


def _f32(conf):
    return {**conf, "torch_dtype": "float32"}


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("part", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(part):
    path = ROOT / "bench_port" / part
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    for f in files:
        assert not set(_top_imports(f)) & FORBIDDEN, f


def test_decoder_scoring_matches_the_port():
    from ray_tpu_torch.models.training import build_forward

    from bench_port.system import decoder as system

    conf = _f32(tiny.cell("mistral7b-serve-poisson")["conf"])
    weights = inputs.family(conf).make_weights(conf, 5, "cpu")
    prompts = [torch.randint(0, 256, (n,)) for n in (7, 19, 32)]
    fwd = build_forward(system.port_config(conf, {"remat": "off"}),
                        device="cpu")
    port = torch.cat([fwd(weights, p[None])[:, -1] for p in prompts])
    ref = reference.family(conf).score_last(conf, weights, prompts)
    torch.testing.assert_close(port, ref, rtol=1e-4, atol=1e-4)


def test_train_loss_and_grads_match_the_port():
    from ray_tpu_torch.models import transformer

    from bench_port.system import decoder

    c = tiny.cell("mistral7b-train-s4096")
    conf = _f32(c["conf"])
    family = inputs.family(conf)
    weights = family.make_weights(conf, 6, "cpu")
    batch = family.make_batch(conf, c["traffic"], 6, 0, "cpu")
    cfg = decoder.port_config(conf, c["traffic"])
    port_loss = functools.partial(transformer.loss_fn, tokens=batch, cfg=cfg)
    leaves = [leaf.requires_grad_(True) for _, leaf in flatten(weights)]
    got = port_loss(weights)
    got_grads = torch.autograd.grad(got, leaves)
    ref_mod = reference.family(conf)
    want = ref_mod.loss(weights, batch, conf, reference.MATMUL["fp32"])
    want_grads = torch.autograd.grad(want, leaves)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5)


def test_fp8_control_rounds_to_e4m3():
    x = torch.tensor([1.0, 0.3, -448.0, 1e-3])
    q = reference.fp8_round(x)
    assert q[2] == -448.0 and q[0] == 1.0
    assert (q - x).abs().max() > 0
