"""A tiny run of each kind loads neither JAX nor the JAX package (whole
top-level names), in a fresh interpreter."""

import json
import subprocess
import sys

import pytest

from bench_port.tests.conftest import ROOT

SCRIPT = """
import json, sys
from bench_port.tests import tiny
from bench_port import run
tiny.execute({workload!r}, seconds=1.0)
print(json.dumps(run.forbidden_modules()))
"""


@pytest.mark.parametrize("workload", ["mistral7b-train-s4096",
                                      "mistral7b-serve-poisson"])
def test_a_run_loads_no_jax(workload):
    out = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(workload=workload)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from bench_port import run

    monkeypatch.setitem(sys.modules, "ray_tpu_torch_lookalike", sys)
    assert "ray_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
