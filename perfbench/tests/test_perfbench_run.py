"""The entry's refusals: no card, no result line."""
from __future__ import annotations

import os
import subprocess
import sys

from perfbench import common


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(common.ROOT / "run.py"), "--workload",
         "mistral-train-4k", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=common.REPO, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_no_result():
    out = subprocess.run(
        [sys.executable, str(common.ROOT / "run.py"), "--workload", "nope",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        cwd=common.REPO, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
