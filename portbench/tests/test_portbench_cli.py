"""The command refuses to measure without a card: it exits 2 and prints
no result line."""
import os
import subprocess
import sys

import _tiny


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "static1m_packed.batch_eval", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=_tiny.ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
