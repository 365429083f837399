"""Without a CUDA device the benchmark exits with a code other than 0 and
prints no result, rather than falling back to the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the card-less path")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "olmo-1b.preempt", "--seed", str(2**33), "--seconds",
                          "1", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr
