"""On a CUDA card: a short run of the scoring cell through the command,
its record and ``correct``. Skips without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from leafbench import run


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
def test_short_scoring_run_on_the_card(cuda_card):
    out = subprocess.run(
        [sys.executable, "-m", "leafbench.run", "--workload",
         "sc-b0-score256", "--seed", str(2 ** 31 + 5), "--seconds", "2",
         "--trace", "1"], cwd=run.ROOT, capture_output=True, text=True,
        timeout=360, env={**os.environ})
    assert out.returncode == 0, out.stderr[-3000:]
    record = json.loads(out.stdout.strip().splitlines()[-1])
    assert record["correct"], record["checks"]
    assert record["device"]["platform"] == "gpu"
    assert record["device"]["busy_s"] > 0
    assert "frontend_roofline.serve" in record["metrics"]
    assert 0 < record["metrics"]["frontend_roofline.serve"]["value"] <= 100
