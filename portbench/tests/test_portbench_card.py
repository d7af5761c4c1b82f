"""On the card: each cell as the check runs it, short, in a fresh process
(`python3 -m portbench.run`), reads correct and prints the contract's
line; and the control at a cell's size is judged not correct. Run on a
card machine with

    python3 -m pytest portbench/tests/test_portbench_card.py -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from portbench import registry

CELLS = [w["name"] for w in json.load(open(os.path.join(
    registry.ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (an NVIDIA H100)")


def _run(args):
    return subprocess.run([sys.executable, "-m", *args], cwd=registry.ROOT,
                          capture_output=True, text=True, timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = _run(["portbench.run", "--workload", cell, "--seed",
                str(2 ** 31 + 101), "--seconds", "3", "--trace", str(trace)])
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    out = _run(["portbench.control", "--workload", cell, "--seeds",
                str(2 ** 31 + 102)])
    assert out.returncode == 0, out.stderr[-3000:]
    checks = json.loads(out.stdout.strip().splitlines()[-1])["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
