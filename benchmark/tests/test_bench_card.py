"""The command as a check runs it: without a card it exits non-zero
and prints no result; with one (a test marked `card`) a cell runs for a
few seconds and prints a correct result naming the card."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def _run(cell, seconds, trace=0):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 3), "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = _run("terrain-1m.preview-1440p", 1)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run("terrain-1m.preview-1440p", 3, trace=1)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert "k1_ms.preview" in res["metrics"] and res["device"]["busy_s"] > 0
    assert list(res)[-1] == "check"
