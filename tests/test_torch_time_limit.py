"""The suite's per-test time limit (the repo root's `conftest.py`), run in a
pytest of its own over a copy of that file with the limit cut to 1 s: a test
that overruns, in its body or in a module-scoped fixture, fails by its name
and the run goes on, also under xdist's loadfile mode; tests that each end
in time pass however long they take together, and the timer and the
SIGALRM handler are as they were after the last test."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HANGS = """
import time

def test_hangs():
    time.sleep(2)

def test_after():
    pass
"""

CASES = {
    "body": ([], HANGS, "1 failed, 1 passed", "test_case.py::test_hangs"),
    "body_xdist": (["-n", "2", "--dist", "loadfile"], HANGS, "1 failed, 1 passed",
                   "test_case.py::test_hangs"),
    "module_fixture": ([], """
import time
import pytest

@pytest.fixture(scope="module")
def slow_reference():
    time.sleep(2)

def test_uses_it(slow_reference):
    pass
""", "1 error", "test_case.py::test_uses_it"),
    "in_time": ([], """
import atexit
import signal
import time

atexit.register(lambda: print("after:", signal.getitimer(signal.ITIMER_REAL)[0],
                              signal.getsignal(signal.SIGALRM) is signal.SIG_DFL))

def test_first():
    time.sleep(0.6)

def test_second():
    time.sleep(0.6)
""", "2 passed", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_limit_fails_an_overrun_by_name(case, tmp_path):
    args, source, summary, overrun = CASES[case]
    with open(os.path.join(REPO, "conftest.py")) as f:
        text = f.read()
    assert text.count("TEST_LIMIT_S = 300\n") == 1
    (tmp_path / "conftest.py").write_text(text.replace("TEST_LIMIT_S = 300\n",
                                                       "TEST_LIMIT_S = 1\n"))
    (tmp_path / "test_case.py").write_text(source)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    res = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          *args, "test_case.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=30)
    out = res.stdout + res.stderr
    assert summary in out, out
    if overrun is None:
        assert res.returncode == 0, out
        assert "after: 0.0 True" in res.stdout, out
        assert "ran past its" not in out
    else:
        assert res.returncode == 1, out
        assert f"{overrun} ran past its 1 s limit" in out, out
