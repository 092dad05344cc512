"""The limits the port's tests run under: torch's pool is this worker's
share of the cores (torch_port_fixtures.py) while XLA:CPU keeps its own
pool and the eight virtual devices, and a port test that outlives its time
limit (worker_limits.py) fails with a traceback while the run goes on.

This module loads worker_limits.py as a plugin: every process that collects
it, as each xdist worker of a run over tests/ does, limits the port's
tests."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import torch

import torch_port_fixtures  # noqa: F401  (sizes torch's pool in an xdist worker)

pytest_plugins = ["worker_limits"]

TESTS = Path(__file__).resolve().parent

CONFTEST = """
pytest_plugins = ["worker_limits"]


def pytest_configure(config):
    import worker_limits

    worker_limits.LIMIT_S = 1
"""

HANGS = """
import os
import time
from pathlib import Path

import pytest


@pytest.fixture
def marks_its_teardown():
    yield
    Path(os.environ["TEARDOWN_MARK"]).write_text("ran")


def test_sleeps_past_its_limit(marks_its_teardown):
    time.sleep(60)


def test_after_the_hang_in_its_process():
    pass
"""

POOL = """
import os
import time

import torch

import torch_port_fixtures


def test_pool_is_the_share_of_two_workers():
    assert os.environ["PYTEST_XDIST_WORKER_COUNT"] == "2"
    assert torch.get_num_threads() == max(1, len(os.sched_getaffinity(0)) // 2)


def test_files_not_of_the_port_have_no_limit():
    time.sleep(2)
"""


def test_torch_pool_is_this_workers_share():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is not None:  # the share is set only in a pytest-xdist worker
        assert torch.get_num_threads() == max(1, len(os.sched_getaffinity(0)) // int(workers))
    assert len(jax.devices()) == 8
    flags = os.environ.get("XLA_FLAGS", "")
    assert "thread" not in flags and "eigen" not in flags, flags


def test_a_hang_fails_on_its_limit_and_the_run_goes_on(tmp_path):
    (tmp_path / "conftest.py").write_text(CONFTEST)
    (tmp_path / "test_torch_hangs.py").write_text(HANGS)
    (tmp_path / "test_pool.py").write_text(POOL)
    mark = tmp_path / "teardown_ran"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = str(TESTS)
    env["TEARDOWN_MARK"] = str(mark)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "xdist", "-n", "2", "--dist", "loadfile", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    out = proc.stdout
    assert proc.returncode == 1, out + proc.stderr
    assert "1 failed, 2 passed, 1 error" in out, out
    assert "FAILED test_torch_hangs.py::test_sleeps_past_its_limit" in out
    assert "Failed: test exceeded its 1 s limit" in out
    assert "time.sleep(60)" in out  # where the test waited
    assert "in test_sleeps_past_its_limit" in proc.stderr, proc.stderr  # the stacks
    assert mark.read_text() == "ran"  # its teardown ran
    # the next test of that process fails at its setup, unrun, and names the cause
    assert "ERROR test_torch_hangs.py::test_after_the_hang_in_its_process" in out
    assert ("not run: test_torch_hangs.py::test_sleeps_past_its_limit ran out of its 1 s limit "
            "in this process") in out
