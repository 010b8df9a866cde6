"""The command on the card: a short run of a one-card cell prints a
result line that holds to the contract's keys and comes out correct.
Skips on the CPU."""

import json
import subprocess
import sys

import pytest

from harness.spec import BENCH, ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["crf_1080p.encode", "crf_1080p.decode"])
def test_short_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        cell, "--seed", str(2**35 + 1), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


def test_no_result_without_a_card():
    """Where there is no CUDA device the command exits non-zero and
    prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "crf_1080p.encode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()
