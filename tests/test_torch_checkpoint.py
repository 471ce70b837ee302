"""The port's checkpoints (``models/checkpoint.py``), on the CPU.

The port's twins of tests/test_model.py's orbax tests: save, trim to
``max_to_keep``, restore, restore with a ``like`` template, the one-shot
helpers and the missing-directory error; then what the torch.save format
adds (a step is whole or absent, background saves, the template's
checks), and a round trip of the tiny MoE train state.

Tolerances: none. A restored leaf is ``torch.equal`` to the saved one,
and training continued from a restored state on the CPU takes the same
losses, bit for bit, as the run that was never interrupted.
"""

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import (
    CheckpointManager,
    restore_train_state,
    save_train_state,
)
from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.models.training import build_train_step, tree_leaves


def _state(offset):
    return {"params": {"w": torch.arange(6.0).reshape(2, 3) + offset,
                       "b": torch.zeros(3) + offset},
            "step": 7 + offset}


def test_checkpoint_roundtrip(tmp_path):
    """save/trim/restore, and restore onto a template (fresh init)."""
    ckpt = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, _state(step))
    assert ckpt.latest_step() == 3
    assert ckpt.all_steps() == [2, 3]  # max_to_keep trimmed step 1
    restored = ckpt.restore(3)
    np.testing.assert_allclose(restored["params"]["w"].numpy(),
                               np.arange(6.0).reshape(2, 3) + 3)
    assert restored["step"] == 10
    like = {"params": {"w": torch.zeros(2, 3, dtype=torch.float64),
                       "b": torch.zeros(3)}, "step": 0}
    again = ckpt.restore_latest(like)
    assert again["params"]["w"].dtype == torch.float64
    np.testing.assert_allclose(again["params"]["b"].numpy(), np.zeros(3) + 3)
    assert again["step"] == 10
    ckpt.close()


def test_one_shot_helpers(tmp_path):
    save_train_state(str(tmp_path / "one"), 5,
                     params={"w": torch.ones(4)}, extra={"epoch": 2})
    out = restore_train_state(str(tmp_path / "one"))
    np.testing.assert_allclose(out["params"]["w"].numpy(), np.ones(4))
    assert out["epoch"] == 2 and "opt_state" not in out
    save_train_state(str(tmp_path / "one"), 6, params={"w": torch.zeros(4)},
                     opt_state={"count": 1, "mu": [torch.ones(4)]})
    assert restore_train_state(str(tmp_path / "one"),
                               step=6)["opt_state"]["count"] == 1
    np.testing.assert_allclose(
        restore_train_state(str(tmp_path / "one"), step=5)["params"]["w"],
        np.ones(4))


def test_restore_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "never-written"))
    assert not os.path.exists(tmp_path / "never-written")
    ckpt = CheckpointManager(str(tmp_path / "empty"))
    assert ckpt.latest_step() is None and ckpt.restore_latest() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(4)


def test_like_checks_shapes_and_tree(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(1, _state(1))
    bad_shape = {"params": {"w": torch.zeros(3, 2), "b": torch.zeros(3)},
                 "step": 0}
    with pytest.raises(ValueError, match=r"state\.params\.w"):
        ckpt.restore(1, like=bad_shape)
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore(1, like={"params": {"w": torch.zeros(2, 3)},
                              "step": 0})
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save(1, _state(2))


def test_background_save_snapshots_the_state(tmp_path):
    """wait=False returns after the host copy: changing the tensors in
    place afterwards does not reach the checkpoint, and the step appears
    whole (no temporary directory is left or listed)."""
    ckpt = CheckpointManager(str(tmp_path / "ck"), max_to_keep=None)
    state = _state(0)
    ckpt.save(1, state, wait=False)
    state["params"]["w"].add_(100.0)
    ckpt.wait_until_finished()
    assert ckpt.all_steps() == [1]
    assert torch.equal(ckpt.restore(1)["params"]["w"],
                       torch.arange(6.0).reshape(2, 3))
    assert sorted(os.listdir(ckpt.directory)) == ["1"]
    assert sorted(os.listdir(os.path.join(ckpt.directory, "1"))) == [
        "state.pt"]


def test_moe_train_state_roundtrip_continues_training(tmp_path):
    """(params, opt_state) of the tiny MoE model after 2 steps, restored
    onto a fresh init through ``like``: every leaf equal, and the next
    two steps take the losses of the run that never stopped."""
    cfg = tfm.ModelConfig.tiny_moe(moe_group_size=32)
    step, init_fn = build_train_step(cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 33))
    params, opt_state = init_fn(torch.Generator().manual_seed(0))
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, tokens)
    ckpt = CheckpointManager(str(tmp_path / "moe"))
    ckpt.save(2, {"params": params, "opt_state": opt_state})
    fresh_p, fresh_o = init_fn(torch.Generator().manual_seed(1))
    restored = ckpt.restore(2, like={"params": fresh_p,
                                     "opt_state": fresh_o})
    ckpt.close()
    saved = tree_leaves(params) + opt_state["mu"] + opt_state["nu"]
    got = (tree_leaves(restored["params"]) + restored["opt_state"]["mu"]
           + restored["opt_state"]["nu"])
    assert len(got) == len(saved)
    assert all(torch.equal(a, b.detach()) for a, b in zip(got, saved))
    assert restored["opt_state"]["count"] == 2
    r_params, r_state = restored["params"], restored["opt_state"]
    for _ in range(2):
        params, opt_state, m = step(params, opt_state, tokens)
        r_params, r_state, r_m = step(r_params, r_state, tokens)
        assert r_m["loss"].item() == m["loss"].item()
    assert r_state["count"] == 4
