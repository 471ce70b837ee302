"""Runs of the harness with the timed path broken underneath: each fault
a cell can have comes out not correct, and the sound run correct. The
look for a chip is skipped (``run.execute`` on the CPU, tiny sizes and
tiny-size limits: ``tiny.py``)."""

import pytest
import torch

from bench_port.tests import tiny

TRAIN = "mistral7b-train-s4096"


@pytest.mark.parametrize("workload", [TRAIN, "mistral7b-serve-poisson"])
def test_sound_run_is_correct(workload):
    out = tiny.execute(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def test_state_left_unchanged(monkeypatch):
    from ray_tpu_torch.models.training import ClippedAdamW

    def frozen(self, params, grads, state, norm=None):
        state["count"] += 1
        for mu, g in zip(state["mu"], grads):
            mu.copy_((1 - self.b1) * g)  # the moments move, the weights not
        return torch.zeros(())

    monkeypatch.setattr(ClippedAdamW, "update", frozen)
    out = tiny.execute(TRAIN)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > 0.9


def test_half_the_batch_left_out(monkeypatch):
    from ray_tpu_torch.models import transformer

    real = transformer.loss_fn

    def half(params, tokens, cfg, attention_fn=None):
        return real(params, tokens[:tokens.shape[0] // 2], cfg, attention_fn)

    monkeypatch.setattr(transformer, "loss_fn", half)
    out = tiny.execute(TRAIN)
    assert not out["correct"]


def test_answer_altered_where_it_is_produced(monkeypatch):
    from ray_tpu_torch.models import training

    real = training.build_forward

    def altered(*args, **kwargs):
        fwd = real(*args, **kwargs)

        def wrong(params, tokens):
            logits = fwd(params, tokens)
            logits[:, :, 0] += 10.0  # one token's logit, every answer
            return logits

        return wrong

    monkeypatch.setattr(training, "build_forward", altered)
    out = tiny.execute("mistral7b-serve-poisson")
    assert not out["correct"]
    assert out["checks"]["logits_rel"]["value"] > 0.08


def test_answers_swapped_between_requests(monkeypatch):
    from ray_tpu_torch.models import training

    real = training.build_forward

    def swapped(*args, **kwargs):
        fwd = real(*args, **kwargs)

        def wrong(params, tokens):
            logits = fwd(params, tokens)
            return logits.roll(1, dims=0) if logits.shape[0] > 1 \
                else logits.roll(1, dims=1)

        return wrong

    monkeypatch.setattr(training, "build_forward", swapped)
    out = tiny.execute("mistral7b-serve-poisson")
    assert not out["correct"]


def test_traced_serve_run_reads_the_window():
    """With --trace 1 the host-path readers read the window's batches,
    and the profiled replay after it leaves the window's answers as they
    are (on the CPU the profiler records nothing, so the device metric
    is left out)."""
    out = tiny.execute("mistral7b-serve-poisson", trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in ("serve.queue_ms", "serve.batch_size", "serve.runtime_ms",
                 "serve.mfu"):
        assert got[name]["value"] > 0, name
    assert "serve.attn_roofline" not in got
