"""The test suite's CPU-thread policy and its per-phase time limit, which
the root ``conftest.py`` applies to every test process.

Torch's default of one intra-op thread per core in each of xdist's
workers spins them against each other, so each worker gets its share of
the host's cores, and the processes its tests spawn inherit the share
through the environment unless the caller set it.
"""
import contextlib
import os
import signal
import threading

THREAD_VARS = ('OMP_NUM_THREADS', 'MKL_NUM_THREADS')
# the caller's own values, read before the policy writes its share
CALLER = {var: os.environ.get(var) for var in THREAD_VARS}
# the longest a test's setup (module fixtures included) or call may run
PHASE_LIMIT_S = 600


def share_threads() -> int:
    """Give this process ``cpu_count // workers`` torch intra-op threads
    and one interop thread; export the share to what it spawns."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', 1))
    share = max(1, os.cpu_count() // workers)
    for var in THREAD_VARS:
        os.environ.setdefault(var, str(share))
    import torch
    torch.set_num_threads(share)  # the worker's share
    torch.set_num_interop_threads(1)
    return share


@contextlib.contextmanager
def time_limit(what: str, seconds: int = PHASE_LIMIT_S):
    """Raise ``TimeoutError`` in the block once it has run ``seconds``
    (main thread only, where the platform has ``SIGALRM``)."""
    if (not hasattr(signal, 'SIGALRM')
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f'{what} ran past {seconds} s')
    saved = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, saved)
