"""The test run's CPU thread policy and its watchdog.

pytest loads this file before `tests/conftest.py`, so the policy is in
force before anything imports torch.

The thread policy: the tier-1 command runs six test workers on an
8-core machine, and each torch process would otherwise start an OpenMP
thread a core. One thread is slower for some evaluations run alone (the
32-atom GRAP Hessian: 2.7 s on 8 threads, 8.0 s on one) but far faster
under six workers (the 32-atom SF Hessian, six processes at once: 106 s
each on 8 threads, 1.3-1.6 s on one). The variables are set with
`setdefault`, so that a caller may still choose its own count, and
before torch is imported, so that the subprocesses of the CLI tests and
the ranks of `parallel.mesh.launch` inherit them;
`torch.set_num_threads(1)` holds the policy in a worker into which a
plugin imported torch first. `tests/test_thread_policy.py` checks both.

The watchdog: a test still running after `WATCHDOG_S` seconds writes
every thread's stack to the run's stderr, and runs on, so that a run cut
by its time limit names the test that held it.
"""
import faulthandler
import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")

import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

WATCHDOG_S = 300.0

_stderr_fd = None


def pytest_configure(config):
    # a copy of the stderr descriptor, taken while output is not captured:
    # during a test the capture redirects fd 2 to a file that a worker
    # killed at the time limit never shows
    global _stderr_fd
    _stderr_fd = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    global _stderr_fd
    if _stderr_fd is not None:
        os.close(_stderr_fd)
        _stderr_fd = None


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    faulthandler.dump_traceback_later(WATCHDOG_S, file=_stderr_fd)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
