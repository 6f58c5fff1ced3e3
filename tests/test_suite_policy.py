"""The suite's own policy (``suite_policy``, applied by the root
``conftest.py``): each test worker's torch runs on its share of the
host's cores, the processes it spawns inherit the share unless the
caller set one, and a test phase that hangs fails at its time limit."""
import os
import time

import pytest
import torch

from suite_policy import CALLER, time_limit


def test_threads_are_the_workers_share():
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', 1))
    share = max(1, os.cpu_count() // workers)
    assert torch.get_num_threads() == share
    assert torch.get_num_interop_threads() == 1
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS'):
        assert os.environ[var] == (CALLER[var] or str(share))


def test_a_phase_past_its_limit_fails():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match='ran past 1 s'):
        with time_limit('sleeper', 1):
            time.sleep(30)
    assert time.monotonic() - t0 < 5
