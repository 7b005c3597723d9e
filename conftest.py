"""Set-up for every pytest run of the repo, loaded before any directory's
own conftest.py.

OpenMP's idle threads spin before they sleep.  The native library and torch
both use OpenMP, and the suite runs six workers on a few cores: each
worker's spinning threads then take the cores that the others'
single-threaded ops need, and a 0.2 s test takes a minute.  PASSIVE puts
them to sleep at once (libgomp's spin count is then 0).  It is set here,
before anything loads an OpenMP runtime; a caller's own setting wins.

Every test runs under a wall-clock limit that covers the set-up and
teardown of its fixtures of every scope.  Past it, SIGALRM fails the test
by name, and the run goes on.  The handler runs between Python bytecodes,
so it cuts a test that overruns in Python or across many native calls, but
not one that never returns from a single native call.
"""

import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

import signal  # noqa: E402

import pytest  # noqa: E402

# wall seconds a test may take, its fixtures' set-up and teardown included
TEST_LIMIT_S = 300


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its {TEST_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def subprocess_timeout():
    """Seconds a test's subprocess may run: less than the test's own limit,
    so that the subprocess's error, with its command, is the one reported."""
    return TEST_LIMIT_S - 60
