"""Each cell of BENCHMARK.json, run briefly on a card (marker ``cuda``; skips
without one):

    python -m pytest portbench/tests/test_portbench_card.py -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest
import torch
from conftest import BENCH

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "4294967391", "--seconds", "3", "--trace", str(trace)],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]
