"""On the card: one short traced run of a cell, whole, in a process of
its own (as BENCHMARK.json's command runs it)."""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.gpu
def test_traced_run_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "gslam_bench.run", "--workload",
         "beams11.office", "--seed", "2147483659", "--seconds", "20",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
    assert "device_idle_pct" in line["metrics"]
    assert list(line)[-1] == "checks"
