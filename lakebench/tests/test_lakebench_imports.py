"""Nothing the command loads is jax or the JAX package, by whole top-level
names; and the command refuses to run without a card."""

import os
import subprocess
import sys

import pytest
from conftest import ROOT

from lakebench.run import forbidden_modules

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import lakebench.run as run, lakebench.control, lakebench.harness, lakebench.spec
from conftest import tiny_cell
from lakebench.harness import Run
import tempfile
for name in ("tpch_sf10.q3_streams3", "tpcds_sf10.q3q55_streams3"):
    cell = tiny_cell(name)
    cell.mix = dict(cell.mix, warmup_rounds=1)
    r = Run(cell, 3, 0.5, False, tempfile.mkdtemp(), "cpu")
    r.setup(); r.measure(); r.release(); r.check_plans(); r.judge()
    for m in cell.per_layer:
        lakebench.spec.module("metrics", m["name"])
print("FORBIDDEN", run.forbidden_modules(sys.modules))
print("TORCH_PORT", "hyperspace_tpu_torch" in sys.modules)
"""


def test_forbidden_names_compare_whole_top_level_names():
    names = ["jax.numpy", "jaxlib", "hyperspace_tpu_torch.engine", "hyperspace_tpux", "flax.linen", "numpy"]
    assert forbidden_modules(names) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["hyperspace_tpu.engine"]) == ["hyperspace_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=ROOT, tests=tests)], capture_output=True,
                         text=True, env=env, timeout=600, cwd=tests)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout and "TORCH_PORT True" in out.stdout


def test_the_command_refuses_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the refusal shows only without one")
    out = subprocess.run([sys.executable, "lakebench/run.py", "--workload", "tpch_sf10.q3_streams3", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
    assert not os.path.exists(os.path.join(ROOT, ".lakebench"))
