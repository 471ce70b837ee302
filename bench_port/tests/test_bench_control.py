"""The control: the float32 reference computed with its products'
operands rounded to float8 e4m3 and put in the program's place must come
out not correct (at tiny sizes, against the tiny-size limits; at the
cells' own sizes the readings are in PERF.md and bench_port/limits/)."""

import pytest
import torch

from bench_port import check, reference
from bench_port.drivers import score
from bench_port.tests import tiny


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_train_control_fails(seed):
    c = tiny.cell("mistral7b-train-s4096")
    conf, traffic = c["conf"], c["traffic"]
    ref_mod = reference.family(conf)
    ref = ref_mod.train_readings(conf, traffic, seed, 3, "cpu")
    fp8 = ref_mod.train_readings(conf, traffic, seed, 3, "cpu",
                                 precision="fp8")
    numbers = check.train_numbers(fp8, ref)
    assert any(numbers[name]["value"] > limit["limit"]
               for name, limit in c["limits"].items()), numbers


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_score_control_fails(seed):
    from bench_port import inputs

    c = tiny.cell("mistral7b-serve-poisson")
    conf = c["conf"]
    _, lengths = score.schedule(c["traffic"], seed, 2.0)
    texts = [torch.as_tensor(t) for t in score.prompts(conf, lengths, seed)]
    weights = inputs.family(conf).make_weights(conf, seed, "cpu")
    ref_mod = reference.family(conf)
    ref = ref_mod.score_last(conf, weights, texts)
    fp8 = ref_mod.score_last(conf, weights, texts, precision="fp8")
    numbers = check.score_numbers(fp8, ref)
    assert numbers["logits_rel"]["value"] > \
        c["limits"]["logits_rel"]["limit"]


@pytest.mark.cuda
def test_cells_run_on_the_card(card):
    """One short run of each cell on the card (``-m cuda`` there)."""
    import json
    import subprocess
    import sys

    from bench_port.tests.conftest import ROOT

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        out = subprocess.run(
            [*manifest["command"], "--workload", w["name"], "--seed",
             str(2 ** 31 + 101), "--seconds", "5", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        assert sys.modules.get("jax") is None
