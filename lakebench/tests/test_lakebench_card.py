"""On the card: one short run of each cell of BENCHMARK.json through the command, correct,
with a result line in the benchmark's format. Marked `cuda`; skips without a
card (decided in the `card` fixture)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from lakebench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(card, name):
    out = subprocess.run([sys.executable, "lakebench/run.py", "--workload", name, "--seed", str(2**31 + 77),
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card and line["device"]["platform"] == "gpu"
    assert line["metrics"]["qps"]["value"] > 0
