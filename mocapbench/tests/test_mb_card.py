"""On the card only: one short run of each cell, traced, whose records
pass the guard and whose outputs agree with the reference.  Run with
``python -m pytest mocapbench/tests/test_mb_card.py -o addopts=""`` on a
machine with a CUDA card; each case skips without one."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["drone4.live150",
                                      "drone4.offline"])
def test_cell_traced_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "-m", "mocapbench.run", "--workload",
                        workload, "--seed", "2147483659", "--seconds", "5",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["metrics"] and line["device"]["busy_s"] > 0
