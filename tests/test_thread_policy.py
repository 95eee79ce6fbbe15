"""The test suite's CPU thread policy (`conftest.py` at the repo's root)
is in force: one torch thread in the test worker, and one OpenMP and MKL
thread in the environment that a subprocess of a test inherits. A file that raises
the count for itself and does not set it back fails the first case when
the runner puts it before this one in the same worker."""
import os
import subprocess
import sys

import torch


def test_a_test_worker_runs_one_torch_thread():
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert os.environ["MKL_NUM_THREADS"] == "1"


def test_a_subprocess_inherits_one_thread():
    code = ("import os, torch; print(os.environ.get('OMP_NUM_THREADS'), "
            "os.environ.get('MKL_NUM_THREADS'), torch.get_num_threads())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["1", "1", "1"]
