"""The one-card cells end to end on a CUDA card, with a short window:
each prints the result line with `correct` true. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench.run import ROOT, benchmark

ONE_CARD = [w["name"] for w in benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
def test_cell_runs_correct_on_the_card(card, workload):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=ROOT.parent, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
