"""On the card: the control, the program at ``compute_dtype=bfloat16``
(the precision below the configurations' float32), must come out not
correct in every cell, through the benchmark's own command at the cells'
sizes and a short window.  Run with ``python -m pytest -m cuda
benchmark/tests`` on a machine with one NVIDIA card."""

import json
import os
import subprocess
import sys

import pytest

from pbench.spec import list_cells, load_benchmark
from portbench_tiny import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list_cells(load_benchmark(ROOT)))
def test_bf16_control_is_not_correct(card, workload):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", workload, "--seed", str(2 ** 31 + 101),
         "--seconds", "4", "--trace", "0", "--control", "bf16"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checks"].values())
