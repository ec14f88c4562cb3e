"""A cell run on the card through the benchmark's command; skips
where there is no CUDA card."""
import json
import subprocess
import sys

import pytest
import torch
from conftest import REPO


@pytest.mark.cuda
def test_the_worklist_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "cardbench/run.py", "--workload",
                        "heightfield-1m.primary-256k", "--seed", "2147483659",
                        "--seconds", "2", "--trace", "1"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    assert res["metrics"]["port_kernels_ms.query"]["value"] > 0
