"""A time limit for each of the PyTorch port's tests (``test_torch_*.py``).

A plugin, loaded through ``pytest_plugins`` by ``tests/test_worker_limits.py``:
every pytest process that collects that module has these hooks before it
runs a test, as each xdist worker of a run over ``tests/`` does. The JAX
package's own test files run without a limit.

- Each phase of a port test (setup, body, teardown) has ``LIMIT_S``
  seconds, so a teardown still runs after a body that ran out. Past it,
  SIGALRM prints the stacks of all the process's threads to its stderr
  and fails the test with the traceback of where its main thread waited.
- That exception lands wherever the main thread was, and may leave the
  process's state half updated. So every later test of the process fails
  at its setup without running, naming the test that ran out, and the
  run goes on in the other processes. (``session.shouldstop`` would stop
  them all: xdist ends the whole run when one worker asks for it.)
- A test stuck inside a C call that never returns to Python cannot be
  failed so: faulthandler prints its stacks ``GRACE_S`` seconds later,
  and it keeps its worker.
"""

import contextlib
import faulthandler
import os
import signal
import sys

import pytest

LIMIT_S = 300
GRACE_S = 30

_stderr = None  # the process's own stderr, not a test's captured one
_ran_out = None  # node id of the test whose limit fired in this process
_fired = False


def pytest_configure(config):
    global _stderr
    _stderr = os.fdopen(os.dup(sys.__stderr__.fileno()), "w")


def _has_limit(item):
    return item.path.name.startswith("test_torch_")


def _on_alarm(signum, frame):
    global _fired
    _fired = True
    faulthandler.dump_traceback(file=_stderr)
    pytest.fail(f"test exceeded its {LIMIT_S} s limit")


@contextlib.contextmanager
def _limited(item):
    global _fired, _ran_out
    if not _has_limit(item):
        yield
        return
    _fired = False
    previous = signal.signal(signal.SIGALRM, _on_alarm)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    faulthandler.dump_traceback_later(LIMIT_S + GRACE_S, file=_stderr)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
        if _fired and _ran_out is None:
            _ran_out = item.nodeid


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    if _ran_out is not None:
        pytest.fail(f"not run: {_ran_out} ran out of its {LIMIT_S} s limit in this process, "
                    "which may have left it in an unknown state")
    with _limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _limited(item):
        return (yield)
