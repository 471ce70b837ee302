"""Multi-host SPMD bring-up of the port (parallel/multihost.py), run for
real, as tests/test_multihost.py runs the JAX package's.

Two OS processes join one gloo group through ``initialize()`` with no
arguments (``RAY_TPU_COORDINATOR`` — here a ``file://`` rendezvous, so
parallel runs never race for a port — ``RAY_TPU_NUM_PROCESSES``,
``RAY_TPU_PROCESS_ID``), build a dp x tp ``multihost_mesh`` and take one
gradient step of ``mean((x @ w) ** 2)`` with x sharded over dp and w over
tp: each rank's loss is its shard's share, summed over the mesh with
``ici.allreduce``; its gradient of w is summed over dp. The loss and the
gradient shard must equal numpy's on the whole arrays within 1e-6
(float32 sums of 8 x 16 x 32 terms), on both ranks. Both layouts of two
ranks run: the dp axis across the two processes, and the tp axis.
The single-process contract: ``initialize`` returns False, and the NCCL
default without a card raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, H = 8, 16, 32

_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed
from ray_tpu_torch.collective.api import ici
from ray_tpu_torch.parallel.mesh import shard_map
from ray_tpu_torch.parallel.multihost import (
    initialize, multihost_mesh, process_count, process_index,
    sync_global_devices)

assert initialize(backend="gloo")
rank = process_index()
assert process_count() == 2
axes = json.loads(sys.argv[1])
mesh = multihost_mesh(axes, dcn_axes=["dp"], device_type="cpu")
B, D, H = 8, 16, 32
x = np.arange(B * D, dtype=np.float32).reshape(B, D) / (B * D)
w = np.ones((D, H), dtype=np.float32) * 0.01
d, t = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")
xs = torch.from_numpy(np.split(x, axes["dp"])[d].copy())
ws = torch.from_numpy(np.split(w, axes["tp"], axis=1)[t].copy())
ws.requires_grad_(True)
with shard_map(mesh):
    # this rank's share of the mean over the whole [B, H] output
    share = ((xs @ ws) ** 2).sum() / (B * H)
    (grad,) = torch.autograd.grad(share, [ws])
    loss = ici.allreduce(share.detach(), ("dp", "tp")).item()
    grad = ici.allreduce(grad, "dp")
sync_global_devices("test-barrier")
np.save(sys.argv[2], grad.numpy())
print(f"MULTIHOST_OK rank={rank} loss={loss!r}", flush=True)
# a gloo group left to the interpreter's exit can abort the process
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 1}, {"dp": 1, "tp": 2}])
def test_two_process_mesh_runs_a_sharded_step(tmp_path, axes):
    import json

    script = tmp_path / "mh_worker.py"
    script.write_text(_WORKER)
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PYTHONPATH=REPO,
                   RAY_TPU_COORDINATOR=f"file://{tmp_path / 'store'}",
                   RAY_TPU_NUM_PROCESSES="2",
                   RAY_TPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), json.dumps(axes),
             str(tmp_path / f"grad{rank}.npy")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    x = np.arange(B * D, dtype=np.float32).reshape(B, D) / (B * D)
    w = np.ones((D, H), dtype=np.float32) * 0.01
    y = x @ w
    expect_loss = float((y ** 2).mean())
    expect_grad = 2 * x.T @ y / (B * H)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        line = next(ln for ln in out.splitlines() if "MULTIHOST_OK" in ln)
        assert f"rank={rank}" in line
        assert abs(float(line.split("loss=")[1]) - expect_loss) < 1e-6
        t = rank if axes["tp"] == 2 else 0
        np.testing.assert_allclose(
            np.load(tmp_path / f"grad{rank}.npy"),
            np.split(expect_grad, axes["tp"], axis=1)[t], atol=1e-6)


def test_single_process_and_the_nccl_default(tmp_path, monkeypatch):
    from ray_tpu_torch.parallel.multihost import initialize

    for var in ("RAY_TPU_COORDINATOR", "RAY_TPU_NUM_PROCESSES",
                "RAY_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    assert initialize(num_processes=1) is False
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a card: the NCCL default would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(f"file://{tmp_path / 'store'}", 2, 0)


@pytest.mark.parametrize("cuda_device,want", [
    (None, [None] * 4),
    (0, [0] * 4),
    ("per_rank", [0, 1, 2, 3]),
])
def test_rank_pool_device_rule(cuda_device, want):
    """The card each rank sets before it joins: none, one for all, or
    rank r on card r (NCCL's one rank a card)."""
    from ray_tpu_torch.parallel.multihost import RankPool, rank_devices

    assert rank_devices(4, cuda_device) == want
    assert RankPool(4, cuda_device=cuda_device).devices == want


@pytest.mark.parametrize("cuda_device", [[0, 1, 2, 3], "card0"])
def test_rank_pool_refuses_a_device_rule_it_cannot_read(cuda_device):
    from ray_tpu_torch.parallel.multihost import RankPool

    with pytest.raises(ValueError, match="cuda_device"):
        RankPool(4, cuda_device=cuda_device)


@pytest.mark.parametrize("cuda_device,backend,match", [
    (0, "gloo", "the ranks name card 0; 0 visible"),
    (1, "nccl", "the ranks name card 1; 0 visible"),
    ("per_rank", None, "4 ranks need 4 visible CUDA cards, 0 visible"),
])
def test_rank_pool_refuses_cards_it_cannot_see(cuda_device, backend, match):
    """A device rule that names cards the host does not show raises
    before any rank starts (here no card is visible); NCCL with one card
    a rank names both counts."""
    from ray_tpu_torch.parallel.multihost import RankPool

    pool = RankPool(4, backend=backend, cuda_device=cuda_device)
    with pytest.raises(RuntimeError, match=match):
        pool.start()
    assert pool._procs == [] and pool._dir is None
