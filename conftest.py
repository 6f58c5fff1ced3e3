"""The test suite's CPU-thread policy and per-phase time limit
(``suite_policy``); ``tests/conftest.py`` sets up the JAX side."""
import os

import pytest

from suite_policy import share_threads, time_limit


def pytest_configure(config):
    # xdist's controller runs no test, and its workers must inherit the
    # caller's environment, not a share worked out for one process
    if (os.environ.get('PYTEST_XDIST_WORKER') is None
            and config.getoption('numprocesses', None)):
        return
    share_threads()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with time_limit(f'{item.nodeid} setup'):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with time_limit(item.nodeid):
        return (yield)
