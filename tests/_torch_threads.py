"""Sizes torch's intra-op thread pool for the port's tests; every
``tests/test_torch_*.py`` imports this module.

Under pytest-xdist each worker is a process of its own, and torch's
default pool takes one thread per core in each: six workers on eight cores
ran the port's heaviest test about 20 times slower than it runs alone.  So
under xdist each worker takes its share of the cores this process may run
on (its affinity mask, else ``os.cpu_count()``),
``cores // PYTEST_XDIST_WORKER_COUNT`` threads (at least one), and
a Python subprocess that a port test starts gets the same count through
``OMP_NUM_THREADS`` (``subprocess_threads``).  Without xdist torch keeps
its default.
"""
import contextlib
import os

import torch


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
THREADS = max(1, _cores() // int(_WORKERS)) if _WORKERS else None
if THREADS is not None:
    torch.set_num_threads(THREADS)


@contextlib.contextmanager
def subprocess_threads():
    """``os.environ`` with ``OMP_NUM_THREADS=THREADS`` (under xdist) for the
    subprocesses started inside the block, which copy it."""
    if THREADS is None:
        yield
        return
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    try:
        yield
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
