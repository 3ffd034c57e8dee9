"""On the card only (marker ``cuda``; each test skips without one):
the control, the plain reference at TF32 products, fails the limits at
the cell's own sizes, and a short run of each cell is correct.

    python -m pytest kbench/tests/test_kbench_card.py -m cuda -q
"""

import json
import subprocess
import sys

import pytest
import torch

from kbench.harness.checks import judge, passed
from kbench.harness.layout import KBENCH_DIR, Layout

ROOT = KBENCH_DIR.parent
CELLS = [w["name"] for w in Layout().benchmark["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    """In a process of its own, as a run is: the card then holds no
    memory of this one."""
    _card()
    out = subprocess.run(
        [sys.executable, "kbench/tools/control.py", "--workload", cell, "--seeds", str(2**31 + 77),
         "--control", "tf32"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    readings = json.loads(out.stdout.strip().splitlines()[-1])
    limits = Layout().cell(cell).config["limits"]
    gaps = {k: v for k, v in readings.items() if k.endswith("_score_gap")}
    assert gaps and not passed(judge(gaps, {k: limits[k] for k in gaps})), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card_is_correct(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "kbench/run.py", "--workload", cell, "--seed", str(2**31 + 78), "--seconds", "2",
         "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
