"""The port stands alone: no module of ray_tpu_torch, and not
chip_smoke.py, imports jax or ray_tpu, and none names a module of
ray_tpu, a ``python -m ray_tpu`` command or one of the JAX package's
state directories in a string (a command template that started the JAX
package's servers would escape the import scan); and its entry points
(the runtime, the model constructors, the train step, the Trainer,
tune.run, the microbenchmark and ``ray up`` on the process provider)
run on CUDA unless the caller asks for the CPU, so on a host without
CUDA they raise instead of running on the CPU. So do RLlib's policies,
trainers and catalog models."""

import ast
import re
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
    tune = [f for f in files
            if f.relative_to(ROOT).parts[:2] == ("ray_tpu_torch", "tune")]
    assert len(tune) == 17  # ray_tpu_torch.tune and its suggest/
    rllib = [f for f in files
             if f.relative_to(ROOT).parts[:2] == ("ray_tpu_torch", "rllib")]
    assert len(rllib) == 16  # every module of ray_tpu/rllib/
    for sub, n in ((("workflow",), 4), (("util", "client"), 4),
                   (("autoscaler",), 10), (("observability",), 9),
                   (("tools", "raycheck"), 7)):
        got = [f for f in files if f.relative_to(ROOT).parts[1:-1] == sub]
        assert len(got) == n, (sub, got)  # as in the JAX package
    runtime_env = [f for f in files
                   if f.relative_to(ROOT).parts[1:-1] == ("_private",)
                   and f.name.startswith("runtime_env")]
    assert len(runtime_env) == 3, runtime_env  # env, installer, packaging
    bad = {}
    for path in files:
        roots = set(_imported_roots(path)) & {"jax", "jaxlib", "ray_tpu",
                                              "optax", "flax"}
        if roots:
            bad[str(path.relative_to(ROOT))] = sorted(roots)
    assert not bad, f"port modules importing the JAX side: {bad}"


# a module path of the JAX package ("ray_tpu.cluster.gcs_server"), a
# command that runs it ("-m ray_tpu"), its state root ("~/.ray_tpu/",
# ".ray_tpu" as a path part) or its log files ("/tmp/ray_tpu_...")
_REFERENCE_IN_STRING = (
    re.compile(r"(?<![\w/])ray_tpu\.[A-Za-z_]"),
    re.compile(r"-m\s+ray_tpu(?!\w)"),
    re.compile(r"(^|[~/])\.ray_tpu(?!\w)"),
    re.compile(r"/tmp/ray_tpu_(?!torch)"),
)


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                yield first.value


def _reference_strings(path):
    """String constants outside docstrings (docstrings cite the JAX
    package as the reference) that name the JAX package's modules,
    commands or state directories."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(d) for d in _docstrings(tree)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            if node.value == ".ray_tpu" or any(
                    p.search(node.value) for p in _REFERENCE_IN_STRING):
                yield node.lineno, node.value


def test_port_strings_name_no_reference_module_or_root():
    bad = {}
    for path in _port_files():
        hits = list(_reference_strings(path))
        if hits:
            bad[str(path.relative_to(ROOT))] = hits
    assert not bad, f"strings naming the JAX package: {bad}"


@pytest.mark.parametrize("text", [
    "exec %s -m ray_tpu.cluster.raylet_server ",
    "ray_tpu.cluster.gcs_server",
    "python -m ray_tpu microbenchmark",
    ".ray_tpu",
    "~/.ray_tpu/clusters",
    "/tmp/ray_tpu_",
])
def test_reference_string_scan_sees_each_form(tmp_path, text):
    """Each form the scan looks for is found in a plain string, and the
    port's own names are not."""
    probe = tmp_path / "probe.py"
    probe.write_text(f'"""ray_tpu.cluster is the reference."""\n'
                     f'X = {text!r}\n'
                     f'Y = {text.replace("ray_tpu", "ray_tpu_torch")!r}\n')
    assert [line for line, _ in _reference_strings(probe)] == [2]


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
                                   "build_train_step", "trainer",
                                   "cluster_state", "params_from_jax",
                                   "tune_run", "rllib_policies",
                                   "rllib_trainer", "rllib_qmix",
                                   "rllib_models", "workflow_init",
                                   "mp_pool", "client_server",
                                   "ray_perf"])
def test_model_entry_points_raise_without_cuda(entry):
    import ray_tpu_torch
    from ray_tpu_torch.core.raylet import ClusterState
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.training import build_forward, build_train_step
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import Trainer

    from ray_tpu_torch import rllib, workflow
    from ray_tpu_torch.rllib import models as rl_models
    from ray_tpu_torch._private import ray_perf
    from ray_tpu_torch.util.client.server import ClientServer
    from ray_tpu_torch.util.multiprocessing import Pool

    _needs_no_cuda()
    cfg = tfm.ModelConfig.debug()

    def every_policy():
        # each raises on its own; the first that does not fails the test
        for cls in (rllib.PPOPolicy, rllib.DQNPolicy, rllib.PGPolicy,
                    rllib.MARWILPolicy, rllib.A2CPolicy, rllib.SACPolicy,
                    rllib.IMPALAPolicy, rllib.policy_extra.APPOPolicy,
                    rllib.DDPGPolicy, rllib.TD3Policy,
                    rllib.ContinuousSACPolicy, rllib.CQLPolicy):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(4, 2)
        raise RuntimeError("no CUDA device: every policy raised")

    calls = {
        "init_params": lambda: tfm.init_params(cfg),
        "build_forward": lambda: build_forward(cfg),
        "build_train_step": lambda: build_train_step(cfg),
        # a Trainer with no runtime brings one up, on CUDA by default
        "trainer": lambda: Trainer(num_workers=1),
        "cluster_state": lambda: ClusterState(),
        "params_from_jax": lambda: params_from_jax({"layers": {}}, cfg),
        # tune.run with no runtime brings the port's up, on CUDA
        "tune_run": lambda: tune.run(lambda config: None),
        # RLlib: a policy, a trainer (its local worker's policy) and
        # QMIX's own networks run on CUDA unless their config asks for
        # the CPU; the catalog's init places its tree on CUDA
        "rllib_policies": every_policy,
        "rllib_trainer": lambda: rllib.PPOTrainer(
            {"env": rllib.StatelessGuessEnv, "num_workers": 0}),
        "rllib_qmix": lambda: rllib.QMixTrainer(
            {"env": rllib.TwoStepCoopEnv}),
        "rllib_models": lambda: rl_models.fcnet((4, 2))[0](
            torch.Generator()),
        # with no runtime, workflow.init, Pool and the ray:// client
        # server bring the port's up, on CUDA
        "workflow_init": lambda: workflow.init(),
        "mp_pool": lambda: Pool(1),
        "client_server": lambda: ClientServer(),
        # the microbenchmark brings the port's runtime up when none is
        "ray_perf": lambda: ray_perf.main(duration=0.01),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not ray_tpu_torch.is_initialized()


def test_cluster_up_without_cuda_fails_to_start(monkeypatch, tmp_path):
    """``ray up`` on the process provider starts a ProcessCluster whose
    GCS solves on CUDA unless the provider config says
    ``gcs_device: "cpu"``: without CUDA that GCS exits at start, and no
    cluster and no state file are left behind."""
    from ray_tpu_torch.autoscaler import commands

    _needs_no_cuda()
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="exited during startup"):
        commands.create_or_update_cluster({
            "cluster_name": "no-cuda",
            "provider": {"type": "process"}})
    assert "no-cuda" not in commands._CLUSTERS
    assert not (tmp_path / ".ray_tpu_torch" / "clusters"
                / "no-cuda.json").exists()


def test_kernel_wrapper_raises_for_unsupported_cuda_input():
    """The kernel's input checks run before any build or launch: a CUDA
    tensor it does not take raises (no plain-path fallback)."""
    from ray_tpu_torch.ops import attention as T

    q = torch.zeros((1, 8, 2, 264))  # head_dim 264: the chunked route
    T._check_kernel_inputs(q, q, q)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        h = q.half()  # no kernel takes fp16, at any head dim
        T._check_kernel_inputs(h, h, h)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        h = q[..., :32].half().contiguous()
        T._check_kernel_inputs(h, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 8, 32)).transpose(1, 2)
        T._check_kernel_inputs(t, t, t)


def test_backward_wrapper_raises_for_unsupported_cuda_input():
    """The backward's input checks run before any build or launch, with
    the forward's rules for q/k/v and the same for out and dout."""
    from ray_tpu_torch.ops import attention as T

    q = torch.zeros((1, 8, 2, 32))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        w = torch.zeros((1, 8, 2, 264)).half()
        T._kernel_bwd(w, w, w, w, lse, w, True, 1.0)
    with pytest.raises(ValueError, match="dout must match q"):
        T._kernel_bwd(q, q, q, q, lse, q.double(), True, 1.0)
    with pytest.raises(ValueError, match="lse"):
        T._kernel_bwd(q, q, q, q, lse.transpose(1, 2), q, True, 1.0)
    assert T._lib is None


def test_process_tier_runs_the_ports_own_worker_and_store():
    """The process tier stands alone too: its workers run the port's
    worker_main (never the JAX package's), with the port's package root
    on their path, and its shm store loads a library built under
    ray_tpu_torch/ from the port's own source."""
    from ray_tpu_torch._native import shm_store
    from ray_tpu_torch.cluster.process_pool import WorkerProcess

    worker = WorkerProcess()
    try:
        argv = worker._proc.args
        assert argv[1:3] == ["-m", "ray_tpu_torch.cluster.worker_main"]
        assert worker.ping()
    finally:
        worker.terminate()
    lib = Path(shm_store._load()._name).resolve()
    assert lib.is_relative_to(ROOT / "ray_tpu_torch" / "_native")
    assert not lib.is_relative_to(ROOT / "ray_tpu")


def test_worker_boot_does_not_load_torch():
    """A process-tier worker imports the package at boot; torch is
    loaded only by the code that uses it, so a worker starts without it
    (the boot cost of every pooled and actor process)."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c", "import sys; "
         "import ray_tpu_torch.cluster.worker_main; "
         "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))"],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
