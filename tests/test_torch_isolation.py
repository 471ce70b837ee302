"""The port stands alone: no module of ray_tpu_torch, and not
chip_smoke.py, imports jax or ray_tpu; and its entry points run on CUDA
unless the caller asks for the CPU, so on a host without CUDA they
raise instead of running on the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_ray_tpu():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = {}
    for path in files:
        roots = set(_imported_roots(path)) & {"jax", "jaxlib", "ray_tpu",
                                              "optax", "flax"}
        if roots:
            bad[str(path.relative_to(ROOT))] = sorted(roots)
    assert not bad, f"port modules importing the JAX side: {bad}"


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")


def test_init_without_device_raises_without_cuda():
    import ray_tpu_torch

    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ray_tpu_torch.init(num_cpus=1)
    assert not ray_tpu_torch.is_initialized()


@pytest.mark.parametrize("entry", ["init_params", "build_forward",
                                   "cluster_state", "params_from_jax"])
def test_model_entry_points_raise_without_cuda(entry):
    from ray_tpu_torch.core.raylet import ClusterState
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.training import build_forward

    _needs_no_cuda()
    cfg = tfm.ModelConfig.debug()
    calls = {
        "init_params": lambda: tfm.init_params(cfg),
        "build_forward": lambda: build_forward(cfg),
        "cluster_state": lambda: ClusterState(),
        "params_from_jax": lambda: params_from_jax({"layers": {}}, cfg),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_kernel_wrapper_raises_for_unsupported_cuda_input():
    """The kernel's input checks run before any build or launch: a CUDA
    tensor it does not take raises (no plain-path fallback)."""
    from ray_tpu_torch.ops import attention as T

    q = torch.zeros((1, 8, 2, 48))  # head_dim 48: not 32/64/128
    with pytest.raises(ValueError, match="head_dim"):
        T._check_kernel_inputs(q, q, q)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        h = q[..., :32].half().contiguous()
        T._check_kernel_inputs(h, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 8, 32)).transpose(1, 2)
        T._check_kernel_inputs(t, t, t)
