"""A wall-clock limit on every test of the repo.

Each phase (setup, call, teardown) of a test gets `TEST_TIME_LIMIT_S`.
Past it, SIGALRM dumps every thread's stack to stderr and fails that
test alone, so a hang costs one test and not the rest of its file
(`--dist loadfile` keeps a file on one worker).  pytest runs a test in
the main thread, also in an xdist worker, and the alarm interrupts a
blocking select or lock wait there; `pytest.fail` raises a
BaseException, which a test's `except Exception` does not swallow.
"""

import faulthandler
import signal
import sys

import pytest

# The slowest test (test_lint.py::test_tree_clean_vs_baseline) takes
# 66-70 s under `-n 6 --dist loadfile` on an 8-core CPU host: 300 s is
# over four times it.
TEST_TIME_LIMIT_S = 300


def _time_limit_hit(_signum, _frame):
    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    pytest.fail(f"test phase ran past its {TEST_TIME_LIMIT_S} s limit"
                " (conftest.py TEST_TIME_LIMIT_S); thread stacks are on"
                " stderr", pytrace=False)


@pytest.hookimpl(hookwrapper=True)
def _time_limited_phase():
    old = signal.signal(signal.SIGALRM, _time_limit_hit)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


pytest_runtest_setup = _time_limited_phase
pytest_runtest_call = _time_limited_phase
pytest_runtest_teardown = _time_limited_phase
